from repro_torch.data.partition import pad_to_equal, random_split, split_by_label
from repro_torch.data.synthetic import (
    WorkerBatcher,
    classification_data,
    linear_regression_data,
    token_stream,
)

__all__ = ["random_split", "split_by_label", "pad_to_equal", "WorkerBatcher",
           "classification_data", "linear_regression_data", "token_stream"]
