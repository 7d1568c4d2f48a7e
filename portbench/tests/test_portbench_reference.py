"""Each model family's plain reference against the port at a tiny size, in
float32 on the CPU, from the benchmark's seeded weights."""
import numpy as np
import pytest
import torch

from portbench import harness, port, weights
from portbench.tests import tiny


@pytest.mark.parametrize("name", ["granite.train.ring-m4", "dsv2lite.train.clique-m2"])
def test_loss_and_gradient_match_port(name):
    from repro_torch.models import model as Mo

    c = dict(tiny.cell(name)["cfg"], torch_dtype="float32")
    ref = harness.reference(c["model_type"])
    W = weights.make(c, 7, "cpu")
    cfg = port.model_config(c, c["model_type"])
    tokens = torch.randint(0, c["vocab_size"], (2, 17), generator=torch.Generator().manual_seed(3))
    Wp = {n: t.clone().requires_grad_() for n, t in W.items()}
    lp = Mo.loss_fn(port.program_params(cfg, Wp), cfg, {"tokens": tokens})
    gp = dict(zip(Wp, torch.autograd.grad(lp, list(Wp.values()))))
    W32 = {n: t.clone().requires_grad_() for n, t in W.items()}
    lr = ref.loss(W32, c, tokens, "fp32")
    gr = dict(zip(W32, torch.autograd.grad(lr, list(W32.values()))))
    assert abs(float(lp.detach()) - float(lr.detach())) < 1e-5
    for n in gr:
        torch.testing.assert_close(gp[n], gr[n], rtol=1e-4, atol=1e-6, msg=n)


@pytest.mark.parametrize("mix", ["train.ring-m4", "train.clique-m2", "train.hypercube-m8"])
def test_reference_consensus_matrix_equals_port(mix):
    from repro_torch.core import topology as T

    g = harness.load_json(harness.HERE / "mixes" / f"{mix}.json")["gossip"]
    want = getattr(T, g["topology"])(**g["args"]).A
    got = harness.reference_topology(g["topology"]).matrix(0, **g["args"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("name", ["granite.train.ring-m4", "dsv2lite.train.clique-m2"])
def test_family_refuses_what_the_port_does_not_run(name):
    c = harness.cell(name)["cfg"]
    key = c["reduced"][1]
    with pytest.raises(ValueError, match=key):
        port.model_config(dict(c, **{key: c["published"][key]}), name)


def test_weights_repeat_for_a_seed_and_differ_across_seeds():
    c = tiny.cell("granite.train.ring-m4")["cfg"]
    a, b, d = (weights.make(c, s, "cpu") for s in (5, 5, 6))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed"], d["embed"])
    assert [n for n, *_ in weights.layout(c)] == list(a)
