"""The whole step's share of the card's bf16 peak: 6·N_active per trained
token of the window, over the window's wall time, against 989 TFLOP/s
(recomputation under remat is not counted)."""
from portbench import yardstick as Y


def read(run):
    if run["kind"] != "train":
        return None
    return 100.0 * Y.train_flops(run["cfg"], run["tokens"]) / run["window_s"] / Y.BF16_PEAK_FLOPS
