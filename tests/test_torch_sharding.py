"""PyTorch port: the mesh layer (parallel/sharding.py, collectives.py) on CPU
shards. shard_problem / gather_problem round-trip bit for bit; the
collectives match plain indexing; the halo-extended band matvec (kernel
K1's plain version on each shard) and the whole sharded reduced matvec
match the single-device ones; meshes and splits that cannot be honoured
raise."""

import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
from solve_keyframe_pose_graph_tpu_torch.ops import gn
from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
from solve_keyframe_pose_graph_tpu_torch.parallel import (
    gather_problem, make_mesh, shard_problem, unshard,
)
from solve_keyframe_pose_graph_tpu_torch.parallel.collectives import (
    OwnerSum, Shards, all_gather, left_halo, rank_sum, right_halo,
)
from solve_keyframe_pose_graph_tpu_torch.parallel.sharded_lm import (
    HaloMatvec, ShardedOps,
)
from solve_keyframe_pose_graph_tpu_torch.parallel.sharding import edge_layout
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, build_problem_np,
)

from test_torch_threads import one_torch_thread  # noqa: F401


def circle_problem(n=200, n_loops=40, n_cap=256, e_cap=64, dtype=np.float64,
                   **graph):
    """A circle graph with dead-zone nodes, frozen nodes, masked edges and
    three priors (one of them masked), so every mask crosses the shards."""
    g = synthetic.circle_graph(n_nodes=n, n_loops=n_loops, seed=0, **graph)
    valid = np.ones(n, bool)
    valid[90:96] = False
    free = np.ones(n, bool)
    free[:12] = False
    lvalid = np.ones(n_loops, bool)
    lvalid[::7] = False
    pri = [0, n * 7 // 20, n * 3 // 4]
    return build_problem_np(
        q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t, node_valid=valid,
        node_free=free, loop_pairs=g.loop_pairs, loop_q=g.loop_q,
        loop_t=g.loop_t, loop_w=g.loop_w, loop_valid=lvalid,
        switch=np.full(n_loops, 0.99), prior_idx=np.array(pri),
        prior_q=g.vio_q[pri], prior_t=g.vio_t[pri],
        prior_w=np.array([1.1, 2.0, 0.0]), n_cap=n_cap, e_cap=e_cap,
        p_cap=4, dtype=dtype, device="cpu")


@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_shard_gather_round_trip_is_bitwise(P):
    prob = circle_problem()
    sp = shard_problem(prob, make_mesh(P, device_type="cpu"))
    back = gather_problem(sp)
    for name in FIELDS:
        got, want = getattr(back, name), getattr(prob, name)
        assert got.dtype == want.dtype and torch.equal(got, want), name
    assert (sp.n_cap, sp.e_cap, sp.p_cap, sp.fanout) == (256, 64, 4, 5)
    # each live loop edge's endpoints are owned or ghosts of its shard
    L = sp.layout
    for i, sub in enumerate(sp.subs):
        assert sub.n_cap == 5 + L.nl + len(L.ghosts[i])
        live = sub.loop_mask > 0.5
        node_of = torch.cat([torch.arange(i * L.nl - 5, (i + 1) * L.nl),
                             L.ghosts[i]])          # local -> global node
        for ends, glob in ((sub.loop_b, sp.loop_b[i]),
                           (sub.loop_a, sp.loop_a[i])):
            assert torch.equal(node_of[ends[live].long()], glob[live].long())
            assert (ends[live] >= 5).all()          # never a halo node
    # each prior is applied by exactly its owner
    owners = sum(s.prior_mask for s in sp.subs)
    assert torch.equal(owners, prob.prior_mask)


def _shards(rng, P, shape):
    return Shards(torch.tensor(rng.normal(size=shape)) for _ in range(P))


def test_collectives_match_plain_indexing():
    rng = np.random.default_rng(0)
    P, nl, w = 4, 8, 3
    x = _shards(rng, P, (6, nl))
    whole = torch.cat(x.parts, dim=1)
    assert torch.equal(unshard(x), whole)
    (got,) = all_gather(x).values()
    assert torch.equal(got, whole)
    lh, rh = left_halo(x, w), right_halo(x, w)
    for i in range(P):
        lo = i * nl
        want_l = whole[:, lo - w:lo] if i else torch.zeros(6, w,
                                                           dtype=whole.dtype)
        want_r = (whole[:, lo + nl:lo + nl + w] if i + 1 < P
                  else torch.zeros(6, w, dtype=whole.dtype))
        assert torch.equal(lh[i], want_l) and torch.equal(rh[i], want_r)
    q = _shards(rng, P, (nl, 4))
    first = torch.ones(w, 4, dtype=q.dtype)
    assert torch.equal(left_halo(q, w, 0, first)[0], first)
    assert torch.equal(left_halo(q, w, 0, first)[2], q.parts[1][-w:])

    vals = [torch.tensor(v) for v in rng.normal(size=P)]
    want = vals[0]
    for v in vals[1:]:
        want = want + v
    assert torch.equal(rank_sum(vals), want)
    assert torch.equal(torch.sum(x * x), rank_sum([torch.sum(p * p)
                                                   for p in x.parts]))

    # ghost rows summed into their owners, in rank order
    ghosts = [np.array([9, 17, 30]), np.array([1, 2, 30]), np.array([]),
              np.array([0, 9, 10])]
    rows = [torch.tensor(rng.normal(size=(len(g), 5))) for g in ghosts]
    got = OwnerSum([g.astype(np.int64) for g in ghosts], nl, ["cpu"] * P)(rows)
    want = torch.zeros(P * nl, 5, dtype=torch.float64)
    for g, r in zip(ghosts, rows):
        for k, u in enumerate(g):
            want[int(u)] += r[k]
    assert torch.equal(torch.cat(got), want)


def test_shards_refuse_ops_along_the_sharded_axis():
    x = Shards([torch.ones(6, 4), torch.ones(6, 4)])
    a = torch.tensor(2.0)
    y = torch.where(a > 1, a * x - 1.0, x / a)
    assert all(torch.equal(p, torch.ones(6, 4)) for p in y.parts)
    assert float(torch.sum(-x + x * x)) == 0.0
    for op in (torch.exp, lambda v: torch.sum(v, dim=0), torch.cumsum):
        with pytest.raises(TypeError):
            op(x) if op is not torch.cumsum else op(x, 1)
    with pytest.raises(TypeError, match="0-d"):
        x * torch.ones(6, 4)


def _reduced(prob, radius=1e4):
    blocks = gn.assemble_t(prob, prob.q, prob.t, prob.switch)
    scale_n, scale_s, lm_n, lm_s = tlm.jacobi_scales(
        blocks.D, blocks.ds, torch.tensor(radius, dtype=prob.dtype))
    return gn.schur_reduce_t(blocks, prob, scale_n, scale_s, lm_n, lm_s)


@pytest.mark.parametrize("P", [2, 8])
def test_halo_band_matvec_matches_the_whole_vector(P):
    rng = np.random.default_rng(P)
    N, F = 128, 5
    D, B, x = (torch.tensor(rng.normal(size=s)) for s in
               ((36, N), (F, 36, N), (6, N)))
    mesh = make_mesh(P, device_type="cpu")
    lb = torch.tensor(rng.integers(0, N, 16), dtype=torch.int32)
    layout = edge_layout(lb, lb.flip(0), N, F, mesh)

    def split(v):
        n = v.shape[-1] // P
        return Shards(v[..., i * n:(i + 1) * n] for i in range(P))

    mv = HaloMatvec(split(D), split(B), split(torch.zeros(36, 16,
                                                          dtype=D.dtype)),
                    layout)
    got = unshard(mv(split(x)))
    want = gn.band_matvec_t(D, B, x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_sharded_reduction_and_matvec_match_single_device(P):
    """The sharded assembly and Schur reduction give the single-device
    blocks, and the sharded reduced matvec the single-device one."""
    prob = circle_problem()
    sp = shard_problem(prob, make_mesh(P, device_type="cpu"))
    ops = ShardedOps(sp, preconditioner="band", residual_mode="6dof",
                     use_switch=True, bcr_levels=2, coarse_group=16)
    blocks = ops.assemble(*ops.initial())
    red, *_ = ops.reduce(blocks, torch.tensor(1e4, dtype=torch.float64))
    want = _reduced(prob)
    for name in ("Dh", "Bh", "rhs_n", "Aba_h", "chb", "cha", "ds_inv",
                 "rhs_s"):
        got = unshard(getattr(red, name))
        ref = getattr(want, name)
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-12 * float(ref.abs().max()))
    x = torch.tensor(np.random.default_rng(1).normal(size=(6, 256)))
    nl = sp.layout.nl
    y = ops.matvec(red)(Shards(x[:, i * nl:(i + 1) * nl] for i in range(P)))
    ref = gn.reduced_matvec_t(want, prob, x)
    torch.testing.assert_close(unshard(y), ref, rtol=0,
                               atol=1e-12 * float(ref.abs().max()))


def test_meshes_and_splits_that_cannot_be_honoured_raise():
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {have + 1} cuda devices.*"
                       f"have {have}"):
        make_mesh(have + 1)
    with pytest.raises(ValueError, match="cuda devices available"):
        make_mesh(devices=[f"cuda:{have}"])
    assert len(make_mesh(3, device_type="cpu")) == 3
    assert len(make_mesh(devices=["cpu"] * 8).distinct) == 1
    prob = circle_problem()
    with pytest.raises(ValueError, match="must divide"):
        shard_problem(prob, make_mesh(3, device_type="cpu"))
    small = circle_problem(n=60, n_loops=8, n_cap=64, e_cap=16)
    with pytest.raises(ValueError, match="narrower than the band halo"):
        shard_problem(small, make_mesh(16, device_type="cpu"))
