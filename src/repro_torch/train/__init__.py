from repro_torch.train.loop import History, train

__all__ = ["History", "train"]
