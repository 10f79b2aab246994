"""PyTorch port: its own host modules against the JAX package's originals.

The port keeps copies of the JAX package's numpy-only modules (config, graph
store and worlds, native store binding, g2o I/O, synthetic graphs, the
dataset analogs, numpy SE(3), viz sink). Each is held here against its original on the CPU: equal
configs and JSON, equal arrays from the same seeds and files, equal store
and world state after the same ingest script, numpy SE(3) to 1e-15, and
equal viz files from the same composed state."""

import dataclasses
import json
import os

import numpy as np
import pytest

from solve_keyframe_pose_graph_tpu import config as jconfig
from solve_keyframe_pose_graph_tpu.compose import vizsink as jviz
from solve_keyframe_pose_graph_tpu.graph import datasets as jdatasets
from solve_keyframe_pose_graph_tpu.graph import g2o as jg2o
from solve_keyframe_pose_graph_tpu.graph import native as jnative
from solve_keyframe_pose_graph_tpu.graph import store as jstore
from solve_keyframe_pose_graph_tpu.graph import synthetic as jsyn
from solve_keyframe_pose_graph_tpu.utils import nse3 as jnse3
from solve_keyframe_pose_graph_tpu_torch import config as tconfig
from solve_keyframe_pose_graph_tpu_torch.compose import vizsink as tviz
from solve_keyframe_pose_graph_tpu_torch.graph import datasets as tdatasets
from solve_keyframe_pose_graph_tpu_torch.graph import g2o as tg2o
from solve_keyframe_pose_graph_tpu_torch.graph import native as tnative
from solve_keyframe_pose_graph_tpu_torch.graph import store as tstore
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic as tsyn
from solve_keyframe_pose_graph_tpu_torch.utils import nse3 as tnse3

from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 1_000_000_000


def _assert_tree_equal(a, b, path=""):
    """Dataclass / dict / list / array trees with equal leaves."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b), path
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("variant", ["default", "edited"])
def test_config_matches_reference(variant):
    jc, tc = jconfig.Config(), tconfig.Config()
    if variant == "edited":
        jc = dataclasses.replace(jc, solver=dataclasses.replace(
            jc.solver, dtype="float64", fp64_backend="tpu", bcr_levels=None),
            capacity=jconfig.CapacityConfig(initial_nodes=512))
        tc = dataclasses.replace(tc, solver=dataclasses.replace(
            tc.solver, dtype="float64", fp64_backend="tpu", bcr_levels=None),
            capacity=tconfig.CapacityConfig(initial_nodes=512))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.to_json() == jc.to_json()
    # a config file written by either package loads in the other
    for src, dst in ((jc, tconfig), (tc, jconfig)):
        back = dst.Config.from_json(src.to_json())
        assert dataclasses.asdict(back) == dataclasses.asdict(jc)
        assert json.loads(back.to_json()) == json.loads(jc.to_json())


@pytest.mark.parametrize("seed,n,loops,outliers", [
    (0, 200, 30, 0.2), (3, 96, 12, 0.0), (11, 501, 64, 0.5)])
def test_circle_graph_matches_reference(seed, n, loops, outliers):
    kw = dict(n_nodes=n, n_loops=loops, seed=seed, outlier_fraction=outliers)
    _assert_tree_equal(tsyn.circle_graph(**kw), jsyn.circle_graph(**kw))


@pytest.mark.parametrize("name,seed", [
    ("sphere2500-analog", 7), ("manhattan3500-analog", 11),
    ("torus-analog", 13)])
def test_dataset_matches_reference(name, seed):
    assert tdatasets.DATASETS.keys() == jdatasets.DATASETS.keys()
    kw = dict(n_nodes=400, n_loops=60, seed=seed)
    _assert_tree_equal(dataclasses.asdict(tdatasets.DATASETS[name](**kw)),
                       dataclasses.asdict(jdatasets.DATASETS[name](**kw)))


def test_datasets_have_loops():
    """tests/test_cli_g2o.py's check, on the port's generators."""
    for name, fn in tdatasets.DATASETS.items():
        g = fn(n_nodes=400, n_loops=60, seed=3)
        odo, loop = g.split_edges()
        assert odo.sum() == g.n_nodes - 1, name
        assert loop.sum() >= 40, (name, loop.sum())


@pytest.mark.parametrize("name", ["sphere2500-analog", "torus-analog"])
def test_g2o_read_write_matches_reference(name, tmp_path):
    path = os.path.join(REPO, "benchmarks", "graphs", f"{name}.g2o")
    jg, tg = jg2o.load_g2o(path), tg2o.load_g2o(path)
    _assert_tree_equal(dataclasses.asdict(tg), dataclasses.asdict(jg))
    _assert_tree_equal(tg2o.g2o_to_problem_inputs(tg),
                       jg2o.g2o_to_problem_inputs(jg))
    out = [str(tmp_path / f"{k}.g2o") for k in ("jax", "port")]
    jg2o.save_g2o(out[0], jg)
    tg2o.save_g2o(out[1], tg)
    assert open(out[1]).read() == open(out[0]).read()
    _assert_tree_equal(dataclasses.asdict(tg2o.load_g2o(out[1])),
                       dataclasses.asdict(jg2o.load_g2o(out[0])))


def _ingest(store):
    """Nodes of two worlds around a kidnap/unkidnap pair, loop edges inside
    each world and one between them, and the merge the engine makes for
    that edge (set_pose_between_worlds)."""
    rng = np.random.default_rng(5)
    t = 1000 * S
    stamps = []
    for i in range(120):
        if i == 50:
            store.kidnap_indicator(t, "kidnapped")
            t += S
        if i == 58:
            store.kidnap_indicator(t, "unkidnapped")
            t += S
        q = tnse3.quat_normalize(rng.normal(size=4))
        store.add_node(t, q, rng.normal(size=3), np.eye(6) * (i + 1))
        stamps.append(t)
        t += S
    for a, b in ((40, 10), (45, 5), (110, 70), (100, 30), (119, 2)):
        q = tnse3.quat_normalize(rng.normal(size=4))
        store.add_loop_edge(stamps[a], stamps[b], q, rng.normal(size=3),
                            float(rng.uniform(0.5, 1.0)), f"edge {a}-{b}")
    store.add_loop_edge(stamps[3] + 5, stamps[1], tnse3.quat_identity(),
                        np.zeros(3), 1.0)          # within the 1 ms match
    store.add_loop_edge(stamps[3] + 2 * S // 3, stamps[1],
                        tnse3.quat_identity(), np.zeros(3), 1.0)  # no match
    store.set_extrinsic([0.0, 0.0, 0.1, 1.0], [0.05, 0.0, 0.02])
    store.worlds.set_pose_between_worlds(
        0, 1, tnse3.quat_normalize([0.0, 0.0, 0.3, 1.0]), [5.0, 7.0, 0.0],
        "first contact")
    store.worlds.get_pose_between_worlds(1, 0)
    store.mark_as_kidnapped_and_signal_end_of_world()
    return store


def _store_state(store, tmp_path, tag):
    path = str(tmp_path / f"{tag}.json")
    store.save_as_json(path)
    return dict(
        nodes=[np.array(a) for a in store.node_arrays()],
        edges=[np.array(a) for a in store.edge_arrays()],
        node_worlds=np.array(store.node_worlds()),
        which=[store.which_world_is_this(int(ts))
               for ts in store.node_arrays()[0]],
        started=[store.nodeidx_of_world_i_started(w) for w in range(3)],
        ended=[store.nodeidx_of_world_i_ended(w) for w in range(3)],
        kidnap=store.kidnap_data_to_json(),
        worlds=store.worlds.to_json(),
        worlds_status=store.worlds.status_json(),
        set_ids=store.worlds.get_world_to_setid_map(),
        descs=[store.edge_description(e) for e in range(store.edge_len)],
        extrinsic=[np.array(store.imu_T_cam_q), np.array(store.imu_T_cam_t)],
        saved=json.load(open(path)),
    )


@pytest.mark.parametrize("kind", ["numpy", "native"])
def test_scripted_ingest_matches_reference(kind, tmp_path):
    if kind == "numpy":
        ref, got = jstore.GraphStore(16), tstore.GraphStore(16)
    else:
        if tnative.load_library() is None or jnative.load_library() is None:
            pytest.skip("libkpg_store.so cannot be built here")
        ref = jnative.NativeGraphStore(16, 4096)
        got = tnative.NativeGraphStore(16, 4096)
    ref_state = _store_state(_ingest(ref), tmp_path, "ref")
    got_state = _store_state(_ingest(got), tmp_path, "got")
    _assert_tree_equal(got_state, ref_state)
    assert got.n_worlds() == 2 and got.edge_len == 6
    assert set(got_state["node_worlds"].tolist()) == {0, 1, -1}
    # a checkpointed store reloads alike, in both packages
    path = str(tmp_path / "got.json")
    _assert_tree_equal(
        _store_state(tstore.GraphStore.load_from_json(path), tmp_path, "r1"),
        _store_state(jstore.GraphStore.load_from_json(path), tmp_path, "r0"))


_QUATS = np.random.default_rng(0).normal(size=(64, 4))
_VECS = np.random.default_rng(1).normal(size=(64, 3))
_UNIT = _QUATS / np.linalg.norm(_QUATS, axis=-1, keepdims=True)
_NSE3_CASES = {
    "quat_identity": (5,),
    "quat_mul": (_UNIT, _UNIT[::-1]),
    "quat_conj": (_UNIT,),
    "quat_normalize": (_QUATS,),
    "quat_rotate": (_UNIT, _VECS),
    "quat_to_rot": (_UNIT,),
    "rot_to_quat": (jnse3.quat_to_rot(_UNIT),),
    "pose_mul": (_UNIT, _VECS, _UNIT[::-1], _VECS[::-1]),
    "pose_inv": (_UNIT, _VECS),
    "pose_relative": (_UNIT, _VECS, _UNIT[::-1], _VECS[::-1]),
    "pose_to_matrix": (_UNIT, _VECS),
    "matrix_to_pose": (jnse3.pose_to_matrix(_UNIT, _VECS),),
    "rot_to_ypr_deg": (jnse3.quat_to_rot(_UNIT),),
    "relative_yaw_deg": (_UNIT,),
}


@pytest.mark.parametrize("name", sorted(_NSE3_CASES))
def test_nse3_matches_reference(name):
    args = _NSE3_CASES[name]
    ref = getattr(jnse3, name)(*args)
    got = getattr(tnse3, name)(*args)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-15)


def test_viz_sink_writes_reference_files(tmp_path):
    """Both packages' writers on one composed port session write the same
    JSON, PPM and NPZ files; the status image agrees too."""
    from test_composer import S as STEP, T0
    from test_torch_composer import _session

    b = _session()
    b.kidnap_indicator(T0 + int(60.5 * STEP), "kidnapped")
    composer = b.composers[1]
    dirs = [str(tmp_path / k) for k in ("jax", "port")]
    for mod, d in zip((jviz, tviz), dirs):
        w = mod.TrajectoryWriter(d, color_by_set=True, last_n_edges=5)
        w.write(composer, tag="final")
        w.write_tick(composer, 3)
    for name in ("viz_final.json", "worlds_status_final.ppm",
                 "viz_live.json", "worlds_status_live.ppm"):
        got = open(os.path.join(dirs[1], name), "rb").read()
        assert got == open(os.path.join(dirs[0], name), "rb").read(), name
    obj = json.load(open(os.path.join(dirs[1], "viz_final.json")))
    assert obj["strips"] and obj["loop_edges"] and obj["odom_residues"]
    npz = [np.load(os.path.join(d, "viz_final.npz")) for d in dirs]
    for k in npz[0].files:
        np.testing.assert_array_equal(npz[1][k], npz[0][k], err_msg=k)
    worlds = composer.store.worlds
    np.testing.assert_array_equal(tviz.render_worlds_status_image(worlds),
                                  jviz.render_worlds_status_image(worlds))
