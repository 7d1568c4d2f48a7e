"""The bus's sharded paths and the ``ppermute``/``allreduce`` backends over
live worker meshes of gloo ranks on the CPU.

One launch of 8 ranks per file (a ``FileStore`` in a temporary directory):
this file, run as a script, is one rank. Meshes: 4 × 1 (ranks 0–3, one
worker each; also 8 workers, two per rank) and 4 × 2 (all 8 ranks, each
replica sharded 2 ways over 'model', with ``param_specs``). Topologies:
the ring, the clique and ``directed_ring_lattice(4, 2)``; backends:
fused (pure mix, fused update, two pipelined chunks, hierarchical, one-peer
time-varying), compressed int8 (two rounds threading the error-feedback
residual), ``ppermute`` and ``allreduce``.

Each rank's output must equal the port's meshless path cut to that rank
(``launch.shardings.local_tree``) bit for bit for the fused and compressed
paths (the same kernel's plain version in the same order), and lie within
``tests/test_bus.py``'s rtol 1e-5 / atol 1e-6 of the meshless einsum for
``ppermute``/``allreduce`` (other summation orders) and of the reference
(its dense oracle; its meshless compressed bus in interpret mode). Every
rank counts its ``batch_isend_irecv`` calls (monkeypatched) against
``bulk_collectives_per_step``, and its bytes sent: on the ring the 4 × 2
mesh sends 1.8–2.2× fewer bytes per rank than the 4 × 1.
"""
import os
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.core import bus
from repro_torch.core import gossip as G
from repro_torch.core import topology as TT
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import WorkerMesh, make_host_mesh
from repro_torch.models.params import PartitionSpec as P

WORLD = 8
RTOL, ATOL = 1e-5, 1e-6
TOPOS = ("ring", "clique", "lattice")
SPECS = {"w": P("data", None, "model", None), "emb": P("data", None, "model"),
         "v": P("data", None, None)}
WHOLE = {k: P("data") for k in SPECS}      # a whole replica on every rank


def _topology(name: str, M: int = 4):
    return TT.directed_ring_lattice(M, 2) if name == "lattice" else TT.make(name, M)


def _params(M: int, seed: int = 0):
    """The global worker-stacked tree, float32, from a numpy seed: two
    leaves that shard over 'model' and one that does not (row-split)."""
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(M, 64, 8, 32)), "emb": rng.normal(size=(M, 256, 64)),
            "v": rng.normal(size=(M, 33, 5))}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in tree.items()}


def _cases():
    """(name, mesh, M, backend, topology, specs) of every case, in the order
    every rank runs them. ``specs`` cut the rank's local tree and are the
    ``param_specs`` passed on; ``WHOLE`` (a whole replica per rank) passes
    none."""
    out = []
    for mesh in ("4x1", "4x2"):
        for topo in TOPOS:
            out += [(f"{mesh}-{topo}-fused", mesh, 4, "fused", topo, SPECS),
                    (f"{mesh}-{topo}-fused-whole", mesh, 4, "fused", topo, WHOLE),
                    (f"{mesh}-{topo}-ppermute", mesh, 4, "ppermute", topo, SPECS),
                    (f"{mesh}-{topo}-allreduce", mesh, 4, "allreduce", topo, SPECS),
                    (f"{mesh}-{topo}-int8", mesh, 4, "int8", topo, WHOLE)]
        out += [(f"{mesh}-ring-update", mesh, 4, "update", "ring", SPECS),
                (f"{mesh}-ring-chunks", mesh, 4, "chunks", "ring", SPECS),
                (f"{mesh}-hier", mesh, 4, "hier", "hier", SPECS),
                (f"{mesh}-onepeer", mesh, 4, "onepeer", "onepeer", SPECS)]
    for backend in ("fused", "ppermute", "allreduce", "int8"):
        out.append((f"m8-ring-{backend}", "4x1", 8, backend, "ring", WHOLE))
    return out


CASES = _cases()


def _spec(topo: str, M: int, backend: str, wm=None):
    kw = dict(backend={"ppermute": "ppermute", "allreduce": "allreduce"}.get(backend, "fused"))
    if topo == "hier":
        t, kw["hierarchical"] = TT.hier(2, 2), True
    elif topo == "onepeer":
        t, kw["time_varying"] = TT.make("ring", M), "one_peer_exp"
    else:
        t = _topology(topo, M)
    if wm is None:
        return G.GossipSpec(topology=t, **kw)
    return G.GossipSpec.for_mesh(t, wm, **kw)


def _run(backend, params, spec, mesh, specs):
    """One case's outputs: a tree, or the trees of two rounds. The update
    tree is a function of each worker's own params, so a rank can make its
    workers' part."""
    ps = None if mesh is None or specs is WHOLE else specs
    upd = _tree.map(lambda x: 0.01 * torch.sin(x), params)
    if backend in ("fused", "ppermute", "allreduce", "hier"):
        return G.mix_pytree(params, spec, mesh, param_specs=ps)
    if backend == "update":
        return bus.mix_bus(params, spec, mesh, updates=upd, eta=-1.0, param_specs=ps)
    if backend == "chunks":
        return bus.mix_bus(params, spec, mesh, nchunks=2, block_r=8, param_specs=ps)
    if backend == "onepeer":
        return [bus.mix_and_update_time_varying(params, spec, upd, step, mesh,
                                                param_specs=ps)
                for step in (0, 1)]
    if backend == "int8":
        first, res = bus.mix_bus_compressed(params, spec, mesh, wire_dtype="int8")
        second, res = bus.mix_bus_compressed(first, spec, mesh, wire_dtype="int8",
                                             residual=res)
        return [first, second]
    raise ValueError(backend)


def _rank_main(rank: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    count = {"calls": 0, "bytes": 0, "gathers": 0, "allreduces": 0}
    real_batch, real_gather, real_reduce = (dist.batch_isend_irecv, dist.all_gather,
                                            dist.all_reduce)

    def batch(ops):
        count["calls"] += 1
        count["bytes"] += sum(op.tensor.numel() * op.tensor.element_size()
                              for op in ops if op.op is dist.isend)
        return real_batch(ops)

    def gather(*a, **kw):
        count["gathers"] += 1
        return real_gather(*a, **kw)

    def reduce(*a, **kw):
        count["allreduces"] += 1
        return real_reduce(*a, **kw)

    dist.batch_isend_irecv, dist.all_gather, dist.all_reduce = batch, gather, reduce
    meshes = {"4x1": make_host_mesh(data=4, model=1, device="cpu"),
              "4x2": make_host_mesh(data=4, model=2, device="cpu")}
    out = {"refused": None, "cases": {}}
    try:
        make_host_mesh(data=4, model=2, device="cuda")
    except ValueError as e:
        out["refused"] = str(e)
    for name, mesh_name, M, backend, topo, specs in CASES:
        dm = meshes[mesh_name]
        if dm.get_coordinate() is None:
            continue
        wm = WorkerMesh.from_mesh(dm)
        coord = wm.coordinate
        local = S.local_tree(_params(M), specs, wm)
        for k in count:
            count[k] = 0
        result = _run(backend, local, _spec(topo, M, backend, wm), wm, specs)
        out["cases"][name] = {"coord": coord, "out": result, **count}
    out["rank_of"] = [WorkerMesh.from_mesh(meshes["4x2"]).rank_of(j, s)
                      for j in range(4) for s in range(2)]
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch the 8 ranks once; load what each wrote."""
    tmp = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join([src] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                               str(tmp / "store"), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode]
    assert not bad, bad
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _meshless(M, backend, topo):
    """The port's one-device result; for ppermute/allreduce the einsum
    oracle and the workers' mean."""
    if backend == "ppermute":
        return G.mix_pytree_reference(_params(M), _topology(topo, M).A)
    if backend == "allreduce":
        return _tree.map(lambda x: x.mean(0, keepdim=True).expand_as(x), _params(M))
    return _run(backend, _params(M), _spec(topo, M, backend), None, None)


def _wm_abstract(mesh_name):
    from repro_torch.launch.mesh import AbstractMesh

    k = int(mesh_name[-1])
    return WorkerMesh.from_mesh(AbstractMesh((4, k), ("data", "model")))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_each_rank_equals_the_meshless_path(ranks, case):
    name, mesh_name, M, backend, topo, specs = case
    want = _meshless(M, backend, topo)
    wm = _wm_abstract(mesh_name)
    seen = 0
    for r in ranks:
        got = r["cases"].get(name)
        if got is None:
            continue
        seen += 1
        cut = [S.local_tree(t, specs, wm, coordinate=got["coord"])
               for t in (want if isinstance(want, list) else [want])]
        outs = got["out"] if isinstance(got["out"], list) else [got["out"]]
        for a, b in zip(_tree.leaves(outs), _tree.leaves(cut)):
            assert a.shape == b.shape
            if backend in ("ppermute", "allreduce"):
                torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
            else:
                assert torch.equal(a, b), name
    assert seen == (4 if mesh_name == "4x1" else 8)


COUNTED = [c for c in CASES if c[3] in ("fused", "ppermute", "int8", "chunks")]


@pytest.mark.parametrize("case", COUNTED, ids=[c[0] for c in COUNTED])
def test_exchange_counts(ranks, case):
    """``batch_isend_irecv`` calls per rank: one per non-identity permutation
    (and chunk) on the bus, values and scales together on the int8 lane;
    one per leaf and permutation for ``ppermute``. The model-sharded bus
    adds one all-gather for the row-split leaf, only with k = 2."""
    name, mesh_name, M, backend, topo, specs = case
    spec = _spec(topo, M, backend)
    per_step = bus.bulk_collectives_per_step(spec, nchunks=2 if backend == "chunks" else 1)
    want = {"fused": per_step, "chunks": per_step, "int8": 2 * per_step,
            "ppermute": per_step * len(SPECS)}[backend]
    k = int(mesh_name[-1])
    for r in ranks:
        got = r["cases"].get(name)
        if got is None:
            continue
        assert got["calls"] == want, (name, got["calls"])
        sharded = specs is SPECS and backend in ("fused", "chunks") and k == 2
        assert got["gathers"] == (1 if sharded else 0)


def test_allreduce_backend_reduces_once_per_leaf_per_worker_axis(ranks):
    for r in ranks:
        for name, got in r["cases"].items():
            if name.endswith("-allreduce"):
                assert got["allreduces"] == len(SPECS) and got["calls"] == 0


def test_model_sharding_halves_the_bytes_per_rank(ranks):
    """The ring's fused mix with param_specs: per-rank bytes sent at k = 2
    are 1.8–2.2× fewer than at k = 1, at the same number of exchanges."""
    sent = {k: [r["cases"][f"4x{k}-ring-fused"]["bytes"] for r in ranks
                if f"4x{k}-ring-fused" in r["cases"]] for k in (1, 2)}
    assert len(set(sent[1])) == 1 and len(set(sent[2])) == 1
    ratio = sent[1][0] / sent[2][0]
    assert 1.8 <= ratio <= 2.2, sent


def test_live_mesh_refuses_another_backend_and_places_ranks(ranks):
    assert all("nccl" in r["refused"] for r in ranks)
    assert ranks[0]["rank_of"] == list(range(8))       # (worker, shard) row-major
    coords = sorted((r["cases"]["4x2-ring-fused"]["coord"]["data"],
                     r["cases"]["4x2-ring-fused"]["coord"]["model"]) for r in ranks)
    assert coords == [(j, s) for j in range(4) for s in range(2)]


@pytest.mark.parametrize("topo", TOPOS)
def test_sharded_paths_match_the_reference(ranks, topo):
    """Each rank's fused, ppermute and allreduce output against the
    reference's dense oracle; the int8 lane against the reference's
    meshless compressed bus (interpret mode)."""
    jax = pytest.importorskip("jax")
    from repro.core import bus as jbus
    from repro.core import topology as JT
    from repro.core.gossip import GossipSpec as JSpec
    from repro.core.gossip import mix_pytree_reference as jref

    jparams = {k: jax.numpy.asarray(v.numpy()) for k, v in _params(4).items()}
    jt = JT.directed_ring_lattice(4, 2) if topo == "lattice" else JT.make(topo, 4)
    dense = {k: torch.from_numpy(np.array(v)) for k, v in jref(jparams, jt.A).items()}
    mean = {k: torch.from_numpy(np.asarray(v).mean(0, keepdims=True).repeat(4, 0))
            for k, v in jparams.items()}
    first, res = jbus.mix_bus_compressed(jparams, JSpec(topology=jt, backend="fused"),
                                         wire_dtype="int8", interpret=True)
    comp = {k: torch.from_numpy(np.array(v)) for k, v in first.items()}
    for mesh_name in ("4x1", "4x2"):
        wm = _wm_abstract(mesh_name)
        for backend, want, specs in (("fused", dense, SPECS), ("ppermute", dense, SPECS),
                                     ("allreduce", mean, SPECS), ("int8", comp, WHOLE)):
            for r in ranks:
                got = r["cases"].get(f"{mesh_name}-{topo}-{backend}")
                if got is None:
                    continue
                out = got["out"][0] if backend == "int8" else got["out"]
                cut = S.local_tree(want, specs, wm, coordinate=got["coord"])
                for a, b in zip(_tree.leaves(out), _tree.leaves(cut)):
                    torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
