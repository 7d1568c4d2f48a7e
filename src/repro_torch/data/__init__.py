from repro_torch.data.partition import pad_to_equal, random_split
from repro_torch.data.synthetic import (
    WorkerBatcher,
    classification_data,
    linear_regression_data,
    token_stream,
)

__all__ = ["random_split", "pad_to_equal", "WorkerBatcher",
           "classification_data", "linear_regression_data", "token_stream"]
