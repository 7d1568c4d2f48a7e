"""The port's decentralized train step and loop against the JAX reference.

K=3 steps from the same initial weights on the same batches, on the
paper's three problems as ``benchmarks/common.py`` builds them (linear
regression, the MLP classifier, the reduced LM at ``problem_lm``'s widths).
Params and every StepMetrics field are compared after each step in float32
at rtol 1e-4 / atol 1e-6: both sides run the same float32 arithmetic, but
matmuls and reductions sum in different orders, and three steps of momentum
carry those last bits forward. The optimizer test pins bf16 rounding bit for
bit.
"""
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import common  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.decentralized import init_state as j_init_state  # noqa: E402
from repro.core.decentralized import make_train_step as j_make_train_step  # noqa: E402
from repro.core.decentralized import replicate_for_workers as j_replicate  # noqa: E402
from repro.core.gossip import GossipSpec as JSpec  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.train.loop import train as j_train  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.decentralized import init_state as t_init_state  # noqa: E402
from repro_torch.core.decentralized import make_train_step as t_make_train_step  # noqa: E402
from repro_torch.core.decentralized import replicate_for_workers as t_replicate  # noqa: E402
from repro_torch.core.gossip import GossipSpec as TSpec  # noqa: E402
from repro_torch.data import WorkerBatcher, pad_to_equal, random_split  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import train as t_train  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
K = 3


# ---------------------------------------------------------------------------
# The three problems, port side (the JAX side is benchmarks/common.py)
# ---------------------------------------------------------------------------


def _torch_linear(params, batch):
    bx, by = batch
    return torch.mean((bx @ params["w"] - by) ** 2)


def _torch_classifier(params, batch):
    bx, by = batch
    h = torch.tanh(bx @ params["W1"] + params["b1"])
    lp = torch.log_softmax(h @ params["W2"] + params["b2"], dim=-1)
    return -torch.mean(torch.gather(lp, -1, by[:, None].long()))


def _problem(name):
    """(arrays, params0 as numpy, JAX loss, port loss)."""
    if name == "linear":
        arrays, _, p0, jloss, _ = common.problem_linear(S=256, n=16)
        return arrays, jax.tree.map(np.asarray, p0), jloss, _torch_linear
    if name == "mlp":
        arrays, _, p0, jloss, _ = common.problem_classifier(S=256, n=16)
        return arrays, jax.tree.map(np.asarray, p0), jloss, _torch_classifier
    arrays, _, p0, jloss, _ = common.problem_lm(S=64, seq=16)
    # problem_lm's widths (benchmarks/common.py)
    tcfg = tget_config("granite-3-2b", reduced=True, n_layers=2, d_model=64,
                       n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256)
    return (arrays, jax.tree.map(np.asarray, p0), jloss,
            lambda p, b: TM.loss_fn(p, tcfg, {"tokens": b[0]}))


def _optimizers(kind):
    if kind == "sgd":
        return joptim.sgd(0.05), toptim.sgd(0.05)
    nesterov = kind == "nesterov"
    return (joptim.momentum_sgd(0.05, 0.9, nesterov=nesterov),
            toptim.momentum_sgd(0.05, 0.9, nesterov=nesterov))


def _assert_trees_close(jtree, ttree, what):
    jl, tl = jax.tree.leaves(jtree), _tree.leaves(ttree)
    assert len(jl) == len(tl), what
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=what)


STEP_CASES = [
    # problem, topology, M, backend, mode, mix_first, period, optimizer
    ("linear", "ring", 4, "fused", "gossip", True, 1, "sgd"),
    ("linear", "clique", 4, "einsum", "gossip", True, 1, "momentum"),
    ("linear", "torus", 4, "fused", "gossip", False, 1, "momentum"),
    ("mlp", "ring", 8, "fused", "gossip", True, 2, "momentum"),
    ("mlp", "torus", 9, "einsum", "gossip", True, 2, "sgd"),
    ("mlp", "clique", 4, "fused", "gossip", True, 1, "nesterov"),
    ("linear", None, 4, None, "allreduce", True, 1, "momentum"),
    ("mlp", None, 4, None, "allreduce", True, 1, "sgd"),
    ("lm", "ring", 4, "fused", "gossip", True, 1, "momentum"),
] + [pytest.param(*c, marks=pytest.mark.slow) for c in [
    ("lm", "ring", 4, "einsum", "gossip", False, 2, "sgd"),
    ("mlp", "ring", 8, "fused", "gossip", False, 2, "nesterov"),
    ("linear", "torus", 16, "fused", "gossip", True, 1, "momentum"),
]]


@pytest.mark.parametrize("problem,topo,M,backend,mode,mix_first,period,opt", STEP_CASES)
def test_train_step_matches_reference(problem, topo, M, backend, mode, mix_first,
                                      period, opt):
    arrays, p0, jloss, tloss = _problem(problem)
    jopt, topt = _optimizers(opt)
    kw_j, kw_t = dict(mode=mode, mix_first=mix_first), dict(mode=mode, mix_first=mix_first)
    if mode == "gossip":
        kw_j["gossip"] = JSpec(topology=JT.make(topo, M), backend=backend, period=period)
        kw_t["gossip"] = TSpec(topology=TT.make(topo, M), backend=backend, period=period)
        jp0, tp0 = j_replicate(jax.tree.map(jnp.asarray, p0), M), t_replicate(
            convert.params_from_jax(p0, device="cpu"), M)
    else:
        jp0, tp0 = jax.tree.map(jnp.asarray, p0), convert.params_from_jax(p0, device="cpu")
    jstep = jax.jit(j_make_train_step(jloss, jopt, **kw_j))
    tstep = t_make_train_step(tloss, topt, **kw_t)
    jst, tst = j_init_state(jp0, jopt), t_init_state(tp0, topt)
    batcher = WorkerBatcher(arrays, pad_to_equal(random_split(len(arrays[0]), M)),
                            batch_size=4, seed=0)
    for k in range(K):
        batch = batcher.next()
        if mode == "allreduce":   # one copy over the whole batch
            batch = tuple(a.reshape((-1,) + a.shape[2:]) for a in batch)
        jst, jm = jstep(jst, tuple(jnp.asarray(a) for a in batch))
        tst, tm = tstep(tst, convert.to_device(batch, "cpu"))
        assert tst.step == int(jst.step) == k + 1
        _assert_trees_close(jst.params, tst.params, f"params after step {k}")
        _assert_trees_close(jst.opt_state, tst.opt_state, f"opt state after step {k}")
        for name, a, b in zip(tm._fields, jm, tm):
            np.testing.assert_allclose(b.item(), float(a), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} at step {k}")


def test_train_step_without_stats_matches_reference():
    """``make_train_step(compute_stats=False)``: the same params and loss,
    and E, E_sp, H and the spread are float32 zeros, as in the reference."""
    arrays, p0, jloss, tloss = _problem("mlp")
    jopt, topt = _optimizers("momentum")
    M = 4
    jstep = jax.jit(j_make_train_step(jloss, jopt, gossip=JSpec(
        topology=JT.make("ring", M), backend="fused"), compute_stats=False))
    tstep = t_make_train_step(tloss, topt, gossip=TSpec(
        topology=TT.make("ring", M), backend="fused"), compute_stats=False)
    jst = j_init_state(j_replicate(jax.tree.map(jnp.asarray, p0), M), jopt)
    tst = t_init_state(t_replicate(convert.params_from_jax(p0, device="cpu"), M), topt)
    batcher = WorkerBatcher(arrays, pad_to_equal(random_split(len(arrays[0]), M)),
                            batch_size=4, seed=0)
    for k in range(2):
        batch = batcher.next()
        jst, jm = jstep(jst, tuple(jnp.asarray(a) for a in batch))
        tst, tm = tstep(tst, convert.to_device(batch, "cpu"))
        _assert_trees_close(jst.params, tst.params, f"params after step {k}")
        np.testing.assert_allclose(tm.loss.item(), float(jm.loss), rtol=RTOL, atol=ATOL)
        for name in ("grad_energy", "grad_spread", "mean_grad_norm", "param_spread"):
            value = getattr(tm, name)
            assert value.dtype == torch.float32 and value.item() == 0.0
            assert float(getattr(jm, name)) == 0.0


def test_train_loop_matches_reference_history(tmp_path, monkeypatch):
    """The loop's History matches the reference's; with ``ckpt_path``,
    ``ckpt_every=2`` both loops save after the same steps (2, 4 and the last,
    5), and the files hold the port's final state bit for bit, restored by
    either package."""
    from repro.train import checkpoint as JC
    from repro_torch.train import checkpoint as TC

    arrays, p0, jloss, tloss = _problem("linear")
    M, steps = 4, 5
    parts = pad_to_equal(random_split(len(arrays[0]), M))
    saves = {"j": [], "t": []}
    for side, mod in (("j", JC), ("t", TC)):
        real = mod.AsyncCheckpointWriter.save

        def spy(self, path, tree, step=None, *, _real=real, _side=side, **kw):
            saves[_side].append((step, kw.get("sharded", False)))
            return _real(self, path, tree, step, **kw)

        monkeypatch.setattr(mod.AsyncCheckpointWriter, "save", spy)

    def run(sharded, ckpt_path, port_only=False):
        jb = WorkerBatcher(arrays, parts, batch_size=4, seed=1)
        tb = WorkerBatcher(arrays, parts, batch_size=4, seed=1)
        jopt, topt = _optimizers("momentum")
        ck = dict(ckpt_every=2, ckpt_sharded=sharded)
        jh = None
        if not port_only:
            _, jh = j_train(jloss, j_replicate(jax.tree.map(jnp.asarray, p0), M), jopt,
                            (tuple(jnp.asarray(a) for a in jb.next()) for _ in range(steps)),
                            steps=steps, gossip=JSpec(topology=JT.undirected_ring(M),
                                                      backend="fused"),
                            log_every=2, verbose=False,
                            ckpt_path=os.path.join(tmp_path, "jax"), **ck)
        tstate, th = t_train(tloss, t_replicate(convert.params_from_jax(p0, device="cpu"), M),
                             topt, (tb.next() for _ in range(steps)), steps=steps,
                             gossip=TSpec(topology=TT.undirected_ring(M), backend="fused"),
                             log_every=2, device="cpu", verbose=False,
                             ckpt_path=ckpt_path, **ck)
        return tstate, th, jh

    tpath = os.path.join(tmp_path, "port")
    tstate, th, jh = run(True, tpath)
    assert tstate.step == steps
    for name in ("loss", "grad_energy", "grad_spread", "mean_grad_norm", "param_spread"):
        np.testing.assert_allclose(getattr(th, name), getattr(jh, name), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert len(th.step_time) == len(jh.step_time) == steps
    assert saves["t"] == saves["j"] == [(2, True), (4, True), (5, True)]
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("port.shard")) == \
        [f"port.shard-w{j}.npz" for j in range(M)]
    assert TC.latest_step(tpath) == steps

    def bit_equal(back):
        for a, b in zip(_tree.leaves(back), _tree.leaves(tstate.params), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)

    bit_equal(TC.restore(tpath, tstate.params, device="cpu"))
    jback = JC.restore(tpath, convert.params_to_numpy(tstate.params))
    bit_equal(convert.params_from_jax(jback, device="cpu"))
    # a monolithic checkpoint: the same steps, the same state
    saves["t"].clear()
    mpath = os.path.join(tmp_path, "mono.npz")
    mstate, _, _ = run(False, mpath, port_only=True)
    assert saves["t"] == [(2, False), (4, False), (5, False)]
    for a, b in zip(_tree.leaves(mstate.params), _tree.leaves(tstate.params)):
        assert torch.equal(a, b)
    bit_equal(TC.restore(mpath, tstate.params, device="cpu"))
    assert TC.latest_step(mpath) == steps


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov"])
def test_optimizer_updates_bf16_bit_exact(kind, rng):
    """bf16 pins where each side rounds: −lr·g in float32 then one cast;
    mu·u with mu rounded to bf16 and the product and the sum each rounded."""
    shape = (64, 33)
    p = rng.normal(size=shape).astype(jnp.bfloat16)
    grads = [rng.normal(size=shape).astype(jnp.bfloat16) for _ in range(3)]
    jopt, topt = _optimizers(kind)
    jp = {"a": jnp.asarray(p)}
    tp = convert.params_from_jax({"a": p}, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for k, g in enumerate(grads):
        ju, js = jopt.update({"a": jnp.asarray(g)}, js, jp, jnp.asarray(k, jnp.int32))
        tu, ts = topt.update(convert.params_from_jax({"a": g}, device="cpu"), ts, tp, k)
        for a, b in zip(jax.tree.leaves((ju, js)), _tree.leaves((tu, ts))):
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                convert.params_to_numpy(b).view(np.uint16), np.asarray(a).view(np.uint16))
