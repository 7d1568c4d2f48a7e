"""The port's capacity-routed Mixture-of-Experts against the JAX reference.

Reduced mixtral-8x7b (4 experts, top-2, float32) on the reference's weights
(``convert.params_from_jax``). Routing is compared first and exactly: the
top-k expert indices, which (token, k) pairs are kept, and their slots must
be EQUAL to the reference's, computed step for step with ``jax.lax.top_k``
(ties to the lower index), so a flipped route fails as a route and not as a
tolerance miss. Then values: layer outputs and the aux loss atol 1e-5
(float32, products summed in another order), loss and gradients rtol 1e-4 /
atol 1e-6 (``tests/test_torch_model.py``'s), and one fused train step on a
ring of M = 4 workers at the same tolerances as ``tests/test_torch_train.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import bus as jbus  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.decentralized import init_state as j_init_state  # noqa: E402
from repro.core.decentralized import make_train_step as j_make_train_step  # noqa: E402
from repro.core.decentralized import replicate_for_workers as j_replicate  # noqa: E402
from repro.core.gossip import GossipSpec as JSpec  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import bus as tbus  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.decentralized import init_state as t_init_state  # noqa: E402
from repro_torch.core.decentralized import make_train_step as t_make_train_step  # noqa: E402
from repro_torch.core.decentralized import replicate_for_workers as t_replicate  # noqa: E402
from repro_torch.core.gossip import GossipSpec as TSpec  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6       # loss, gradients, train step
ATOL_OUT = 1e-5               # layer outputs, aux loss


def _cfgs(**overrides):
    return (jget_config("mixtral-8x7b", reduced=True, **overrides),
            tget_config("mixtral-8x7b", reduced=True, **overrides))


def _moe_params(jcfg, seed=0, zero_router=False):
    """Reference-initialised MoE weights: (jax tree, torch tree)."""
    from repro.models.params import init_tree

    jp = init_tree(jax.random.PRNGKey(seed), JL.moe_defs(jcfg))
    if zero_router:                     # every probability equal: ties everywhere
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _x(cfg, B=2, L=24, seed=1):
    return np.random.default_rng(seed).normal(size=(B, L, cfg.d_model)).astype(np.float32)


def _jax_route(jp, jcfg, xf):
    """The reference's routing (``layers._moe_tokens``), step for step:
    (top-k indices, keep, slots)."""
    N = xf.shape[0]
    E, K = jcfg.n_experts, jcfg.top_k
    probs = jax.nn.softmax((xf @ jp["router"]).astype(jnp.float32), axis=-1)
    _, topi = jax.lax.top_k(probs, K)
    capacity = int(np.ceil(N * K / E * jcfg.capacity_factor))
    flat_oh = jax.nn.one_hot(topi, E, dtype=jnp.int32).reshape(N * K, E)
    pos = ((jnp.cumsum(flat_oh, axis=0) - flat_oh) * flat_oh).sum(-1).reshape(N, K)
    keep = pos < capacity
    slot = jnp.where(keep, topi * capacity + pos, E * capacity)
    return np.asarray(topi), np.asarray(keep), np.asarray(slot)


ROUTE_CASES = {
    "base": dict(),
    "overflow": dict(capacity_factor=0.5),          # half the pairs dropped
    "shared": dict(n_shared_experts=1),
    "geglu": dict(mlp_type="geglu"),
    "relu2": dict(mlp_type="relu2"),                # experts without w_gate
    "ties": dict(),                                 # a zero router: all probs equal
}


def _route(tp, tcfg, xf):
    """The port's routing of a flat token matrix through the whole router."""
    return TL._route_logits(tcfg, (xf @ tp["router"]).float())


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_moe_tokens_routing_equal_then_values(case):
    jcfg, tcfg = _cfgs(**ROUTE_CASES[case])
    jp, tp = _moe_params(jcfg, zero_router=case == "ties")
    xf = _x(tcfg).reshape(-1, tcfg.d_model)
    topi, keep, slot = _jax_route(jp, jcfg, jnp.asarray(xf))
    _, t_topi, t_keep, t_slot, capacity, _ = _route(tp, tcfg, torch.from_numpy(xf))
    assert capacity == int(np.ceil(xf.shape[0] * tcfg.top_k / tcfg.n_experts
                                   * tcfg.capacity_factor))
    np.testing.assert_array_equal(t_topi.numpy(), topi)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    np.testing.assert_array_equal(t_slot.numpy(), slot)
    if case == "overflow":
        assert 0 < keep.sum() < keep.size
    if case == "ties":
        assert (topi == np.arange(tcfg.top_k)).all()     # the lower indices first
    jy, jaux = JL._moe_tokens(jp, jcfg, jnp.asarray(xf))
    xt = torch.from_numpy(xf)
    topw, _, t_keep, t_slot, capacity, taux = _route(tp, tcfg, xt)
    ty = TL._dispatch(tp, tcfg, xt, topw, t_keep, t_slot, capacity)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL_OUT, rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=ATOL_OUT, rtol=0)


@pytest.mark.parametrize("dispatch,shard", [
    ("global", "auto"), ("per_sequence", "auto"), ("per_sequence_smap", "auto"),
    ("global", "capacity")])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_apply_every_dispatch_matches(dispatch, shard, shared):
    jcfg, tcfg = _cfgs(moe_dispatch=dispatch, moe_shard=shard, n_shared_experts=shared)
    jp, tp = _moe_params(jcfg, seed=2)
    assert ("shared" in tp) == bool(shared)
    x = _x(tcfg, seed=3)
    if dispatch != "global":    # each sequence routed on its own: its routes equal
        for b in range(x.shape[0]):
            want = _jax_route(jp, jcfg, jnp.asarray(x[b]))
            got = _route(tp, tcfg, torch.from_numpy(x[b]))[1:4]
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.numpy(), w)
    jy, jaux = JL.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, taux = TL.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert tuple(ty.shape) == x.shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL_OUT, rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=ATOL_OUT, rtol=0)


def test_bf16_router_ties_break_to_the_lower_index():
    """bf16 router logits tie often; the stable sort keeps JAX's order where
    torch.topk promises none."""
    probs = torch.tensor([[0.1, 0.4, 0.4, 0.1], [0.25, 0.25, 0.25, 0.25],
                          [0.3, 0.3, 0.1, 0.3]])
    want = np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1])
    got = TL._top_k(probs, 2)[1].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[1, 2], [0, 1], [0, 1]])


def _loss_and_grads_close(jp, jcfg, tp, tcfg, toks):
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)})))(jp)
    tg, tl = torch.func.grad_and_value(
        lambda p: TM.loss_fn(p, tcfg, {"tokens": torch.from_numpy(toks)}))(tp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    jleaves, tleaves = jax.tree.leaves(jg), _tree.leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)
    return tl, tg


def test_scanned_and_list_mixtral_match_the_reference_and_each_other():
    """The 2-layer scan_layers override stacks every leaf, the 3-D expert
    weights included, on a leading layer dim; loss (CE + both layers' aux)
    and gradients equal the reference's scan and the port's list segment."""
    jcfg, tcfg = _cfgs()
    jcfg_s, tcfg_s = _cfgs(scan_layers=True)
    jp = JM.init(jax.random.PRNGKey(4), jcfg)
    jp_s = dict(jp, segments=[jax.tree.map(lambda *xs: jnp.stack(xs), *jp["segments"][0])])
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tp_s = convert.params_from_jax(jax.tree.map(np.asarray, jp_s), device="cpu")
    assert tp_s["segments"][0]["mlp"]["w_up"].shape == (
        2, tcfg.n_experts, tcfg.d_model, tcfg.d_ff_expert)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, size=(2, 41)).astype(np.int32)
    l_list, g_list = _loss_and_grads_close(jp, jcfg, tp, tcfg, toks)
    l_scan, g_scan = _loss_and_grads_close(jp_s, jcfg_s, tp_s, tcfg_s, toks)
    np.testing.assert_allclose(l_scan.item(), l_list.item(), rtol=RTOL)
    stacked = _tree.leaves(g_scan)
    for i, layer in enumerate(g_list["segments"][0]):
        for a, b in zip(_tree.leaves(layer), _tree.leaves(g_scan["segments"][0])):
            np.testing.assert_allclose(b[i].numpy(), a.numpy(), rtol=RTOL, atol=ATOL)
    assert len(stacked) == len(_tree.leaves(g_list)) - len(_tree.leaves(g_list["segments"][0][1]))
    _, aux = TM._forward(tp, tcfg, torch.from_numpy(toks))[::2]
    assert aux.item() > 0                                 # both layers' Switch loss


def test_moe_tree_bus_layout_matches_reference():
    """The flat bus carries the MoE tree (3-D expert leaves, the router) in
    the reference's layout, and round-trips it bit for bit."""
    jcfg, _ = _cfgs(n_shared_experts=1)
    rng = np.random.default_rng(6)
    defs = JM.model_defs(jcfg)
    tree = jax.tree.map(lambda d: rng.normal(size=(4,) + d.shape).astype(np.float32), defs)
    jl = jbus.plan_layout(jax.tree.map(jnp.asarray, tree))
    tt = convert.params_from_jax(tree, device="cpu")
    tl = tbus.plan_layout(tt)
    assert tl.shapes == jl.shapes
    assert tl.padded_elements() == jl.padded_elements()
    assert [(g.rows, g.cols, g.block_r) for g in tl.groups] == \
        [(g.rows, g.cols, g.block_r) for g in jl.groups]
    back = tbus.unpack(tbus.pack(tt, tl), tl)
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(tt), _tree.leaves(back)))


@pytest.mark.parametrize("backend", ["fused", "einsum"])
def test_fused_train_step_on_mixtral_matches_reference(backend):
    """One decentralized step of eq. (3) on the ring, M = 4, momentum SGD:
    the MoE tree through ``make_train_step`` and the bus."""
    M = 4
    jcfg, tcfg = _cfgs()
    p0 = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(7), jcfg))
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size,
                                             size=(M, 2, 33)).astype(np.int32)
    jopt, topt = joptim.momentum_sgd(0.05, 0.9), toptim.momentum_sgd(0.05, 0.9)
    jstep = jax.jit(j_make_train_step(
        lambda p, b: JM.loss_fn(p, jcfg, {"tokens": b}), jopt,
        gossip=JSpec(topology=JT.make("ring", M), backend=backend)))
    tstep = t_make_train_step(
        lambda p, b: TM.loss_fn(p, tcfg, {"tokens": b}), topt,
        gossip=TSpec(topology=TT.make("ring", M), backend=backend))
    jst = j_init_state(j_replicate(jax.tree.map(jnp.asarray, p0), M), jopt)
    tst = t_init_state(t_replicate(convert.params_from_jax(p0, device="cpu"), M), topt)
    jst, jm = jstep(jst, jnp.asarray(toks))
    tst, tm = tstep(tst, torch.from_numpy(toks))
    for a, b in zip(jax.tree.leaves(jst.params), _tree.leaves(tst.params)):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)
    for name, a, b in zip(tm._fields, jm, tm):
        np.testing.assert_allclose(b.item(), float(a), rtol=RTOL, atol=ATOL, err_msg=name)


def test_moe_defs_match_reference_shapes():
    for kw in (dict(), dict(n_shared_experts=1), dict(mlp_type="relu2")):
        jcfg, tcfg = _cfgs(**kw)
        jd = JL.moe_defs(jcfg)
        td = TL.moe_defs(tcfg)
        assert jax.tree.map(lambda d: (d.shape, d.scale), jd,
                            is_leaf=lambda d: hasattr(d, "shape")) == \
            _tree.map(lambda d: (d.shape, d.scale), td)
    assert dataclasses.replace(tcfg).n_experts == 4
