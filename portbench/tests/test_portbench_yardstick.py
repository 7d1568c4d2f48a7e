"""The frozen arithmetic against the hand numbers of the cells' predictions,
and against the port's own counts as they stood when it was frozen."""
import pytest

from portbench import harness, port, weights, yardstick as Y


def cfg(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


def test_parameter_counts():
    assert round(Y.n_params(cfg("granite-3-2b.l8")) / 1e6, 1) == 587.2
    assert round(Y.n_params(cfg("granite-3-2b.l3")) / 1e6, 1) == 283.1
    ds = cfg("deepseek-v2-lite-16b.l2")
    assert round(Y.n_params(ds) / 1e9, 3) == 1.085
    assert round(Y.active_params(ds) / 1e6, 1) == 583.5
    assert round(Y.param_bytes(dict(cfg("granite-3-2b.l8"), num_hidden_layers=40)) / 1e9,
                 2) == 5.07


def test_byte_counts():
    g8, g3 = cfg("granite-3-2b.l8"), cfg("granite-3-2b.l3")
    assert round(8 * Y.param_bytes(g3) / 1e9, 2) == 4.53
    assert Y.mix_bytes(g8, 4) == 3 * 4 * 2 * Y.n_params(g8)


def test_flops():
    g8 = cfg("granite-3-2b.l8")
    assert Y.train_flops(g8, 1000) == 6 * 1000 * Y.n_params(g8)
    ds = cfg("deepseek-v2-lite-16b.l2")
    assert Y.train_flops(ds, 10) == 60 * Y.active_params(ds) < 60 * Y.n_params(ds)


def test_counts_leave_out_norm_scales_only():
    c = cfg("deepseek-v2-lite-16b.l2")
    norms = sum(weights.numel(s) for _, s, sd in weights.layout(c) if sd == "ones")
    assert Y.n_params(c) + norms == sum(weights.numel(s) for _, s, _ in weights.layout(c))


@pytest.mark.parametrize("name", ["granite-3-2b.l8", "granite-3-2b.l3", "deepseek-v2-lite-16b.l2"])
def test_frozen_copy_matches_port(name):
    from repro_torch.launch import roofline

    c = cfg(name)
    mc = port.model_config(c, name)
    assert Y.n_params(c) == mc.n_params()
    assert Y.active_params(c) == roofline.active_params(mc)
