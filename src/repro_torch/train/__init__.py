from repro_torch.train.loop import History, RecoveryPolicy, SimRun, run_simulated, train

__all__ = ["History", "train", "RecoveryPolicy", "SimRun", "run_simulated"]
