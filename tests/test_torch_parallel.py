"""The port's mesh (parallel/mesh.py), ray data parallelism
(parallel/sharded.py), its cost model and dry run, and a map-sharded
session through the CLI (`python -m loopy_slam_torch.run`'s main), over
gloo on the CPU; the ray-DP chunk and the cost model against the JAX
package.

The ranks are spawned processes (tests/torch_rank_workers.py imports no
jax). Tolerances: the collectives exact; the ray-DP chunk (3 geometry + 1
color iterations, the ray pool, 30 rays a frame a rank) as
test_torch_mapping holds its single-device chunk: loss terms within 1e-3
relative, 99.5% of feature and decoder entries within 1e-4; the cost
model's numbers equal to JAX's; the tiny map-sharded session within
ATE 1.5 cm (JAX's own map-shard session test holds 1.5 cm on its
larger session), with the replicated state equal on both ranks.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_workers as workers
from test_torch_map_shard import (assert_chunk_close, chunk_scene, fields,
                                  leaves_with_names)
from loopy_slam_torch.mapping.mapper import MapperOptions as TMapperOptions
from loopy_slam_torch.models.renderer import RenderOptions as TRenderOptions
from loopy_slam_torch.parallel import cost_model as tcm
from loopy_slam_torch.parallel import mesh as tmesh
from loopy_slam_tpu.mapping import point_cloud as jpc
from loopy_slam_tpu.models import decoder as jdec
from loopy_slam_tpu.ops import adam as jadam
from loopy_slam_tpu.parallel import cost_model as jcm
from loopy_slam_tpu.parallel.sharded import (make_mesh,
                                             make_sharded_optimize_map,
                                             replicate)


ROOM = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "Synthetic", "room.yaml")

# a 6-frame room session at test_map_shard_e2e's camera (60x80), budgets cut
# for two single-threaded ranks (mapping 40 / 20 iterations, tracking 10),
# map-sharded over 2 ranks; the small initial capacity makes the shards
# grow at the first mapped frame
SESSION = """inherit_from: {room}
verbose: False
data: {{n_frames: 6, output: {out}}}
cam: {{H: 60, W: 80, fx: 60.0, fy: 60.0, cx: 39.5, cy: 29.5}}
tracking: {{pixels: 200, iters: 10, ignore_edge_W: 4, ignore_edge_H: 4,
  vis_freq: 0}}
mapping: {{every_frame: 2, pixels: 400, pixels_adding: 800, iters: 20,
  iters_first: 40, geo_iter_first: 15, mapping_window_size: 4,
  keyframe_every: 2, color_refine: False, segment_strategy: none,
  vis_freq: 0}}
pointcloud: {{capacity: 32768, initial_capacity: 4096,
  cell_table_size: 65536, radius_add: 0.08, radius_query: 0.16,
  radius_min: 0.04}}
rendering: {{eval_img: False}}
meshing: {{eval_rec: False}}
parallel: {{n_devices: 2, map_shard: True}}
"""


@pytest.fixture(scope="module")
def session_run(tmp_path_factory):
    """The map-sharded session through `python -m loopy_slam_torch.run`
    (its main) on 2 CPU ranks; started by the first test that asks (the
    ray-DP chunk), so it runs beside JAX's compile."""
    from loopy_slam_torch import run

    out = tmp_path_factory.mktemp("session")
    path = out / "session.yaml"
    path.write_text(SESSION.format(room=ROOM, out=out / "run"))
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(run.main, [str(path), "--device", "cpu"])
    yield fut, out / "run"
    pool.shutdown()


def test_backend_rule_and_rank_devices(monkeypatch):
    """gloo on the CPU or when ranks share the one card, nccl with a card
    each, more ranks than cards on several cards refused; rank r on
    cuda:(r % cards)."""
    cpu = torch.device("cpu")
    assert tmesh.choose_backend(2, cpu) == "gloo"
    assert tmesh.rank_device(3, "cpu") == cpu
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert tmesh.rank_device(n + 1) == torch.device("cuda", 1 % n)
        assert tmesh.choose_backend(n, torch.device("cuda", 0)) == "nccl"
        if n == 1:
            assert tmesh.choose_backend(2, torch.device("cuda", 0)) == "gloo"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.rank_device(0)
    # the rule itself, on machines of one and of four cards
    cuda0 = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.choose_backend(1, cuda0) == "nccl"
    assert tmesh.choose_backend(2, cuda0) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.choose_backend(4, cuda0) == "nccl"
    assert tmesh.choose_backend(2, cuda0) == "nccl"
    with pytest.raises(ValueError, match="5 ranks on 4 cards"):
        tmesh.choose_backend(5, cuda0)


def test_mesh_collectives_four_ranks(tmp_path):
    res = tmesh.launch(workers.collectives, 4, device="cpu", timeout_s=60.0,
                       store_dir=str(tmp_path))
    for r, o in enumerate(res):
        np.testing.assert_array_equal(o["psum"], [10.0] * 3)
        assert o["psum_int"].dtype == np.int32 and o["psum_int"].item() == 6
        assert o["pmax"] == 3
        src = (r - 1) % 4
        np.testing.assert_array_equal(o["fwd"][0], np.arange(4.0) + 10 * src)
        assert o["fwd"][1].dtype == np.int32 and o["fwd"][1].item() == src
        np.testing.assert_array_equal(o["back"], np.arange(2.0) + (r + 1) % 4)
        np.testing.assert_array_equal(
            o["rows"], np.repeat(np.arange(4.0), np.arange(1, 5))[:, None]
            .repeat(2, 1))
        assert o["bcast"] == {"from": 0}


def test_ray_dp_train_step_and_render(tmp_path):
    """sharded_train_step: a finite loss, the features moved, the frozen
    color embedder kept; sharded_render: every rank gathers the same
    frame, and its block is the rank's own plain render (same draws)."""
    res = tmesh.launch(workers.ray_dp_helpers, 2, device="cpu",
                       timeout_s=60.0, store_dir=str(tmp_path))
    for o in res:
        assert np.isfinite(o["loss"]) and o["loss"] > 0
        assert o["moved"] > 0 and o["B_kept"]
        assert o["render"][0].shape[0] == o["rays"]
        lo, hi = o["block"]
        for got, own in zip(o["render"], o["own"]):
            np.testing.assert_array_equal(got[lo:hi], own)
        for a, b in zip(o["render"], res[0]["render"]):
            np.testing.assert_array_equal(a, b)
    assert res[0]["loss"] == res[1]["loss"]


def test_launch_raises_when_a_rank_fails(tmp_path):
    """A rank that raises fails launch() in the caller, naming the rank and
    its error, long before the collective timeout of the rank left
    waiting."""
    import time

    t0 = time.perf_counter()
    with pytest.raises(tmesh.RankError, match="rank 1 of 2 failed"
                       "(.|\n)*fails on purpose"):
        tmesh.launch(workers.raise_on_rank1, 2, device="cpu",
                     timeout_s=60.0, store_dir=str(tmp_path))
    assert time.perf_counter() - t0 < 50.0
    assert not os.listdir(tmp_path)  # the store and results are removed


def test_no_single_device_fallback(tmp_path):
    """parallel.n_devices > 1 never runs the single-device program: without
    a mesh of that size the session refuses to start."""
    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.slam import LoopySLAM

    path = tmp_path / "session.yaml"
    path.write_text(SESSION.format(room=ROOM, out=tmp_path / "run"))
    with pytest.raises(RuntimeError, match="one process per rank"):
        LoopySLAM(load_config(str(path)), device="cpu")


def test_cost_model_matches_jax():
    for n in (1, 2, 8):
        assert tcm.bench_budget(n) == pytest.approx(jcm.bench_budget(n),
                                                    rel=0, abs=0)
    trainable = {"dec": [np.zeros((93, 32), np.float32)],
                 "feat": np.zeros((4096, 64), np.float32)}
    jtr = jax.tree.map(jnp.asarray, trainable)
    ttr = {"dec": [torch.zeros(93, 32)], "feat": torch.zeros(4096, 64)}
    for n in (2, 4):
        want = jcm.dp_iter_bytes_per_chip(jtr, n)
        assert tcm.dp_iter_bytes_per_chip(trainable, n) == want
        assert tcm.dp_iter_bytes_per_chip(ttr, n) == want
        assert tcm.mshard_iter_bytes_per_chip(5000, 8, 64, 400_000, n, 2) \
            == jcm.mshard_iter_bytes_per_chip(5000, 8, 64, 400_000, n, 2)
    assert tcm.tree_bytes(ttr) == jcm.tree_bytes(jtr)


def test_dryrun_two_ranks(tmp_path, capsys):
    """Both flavours' chunks inside their loss bands, and the cost record."""
    from loopy_slam_torch.parallel.dryrun import dryrun

    rec = dryrun(2, "cpu", store_dir=str(tmp_path))
    assert "MULTICHIP_COST " in capsys.readouterr().out
    assert rec["n_devices"] == 2 and rec["backend"] == "gloo"
    assert 0.2 < rec["loss_dp"] / rec["loss_single_device"] < 5.0
    assert rec["mshard_iter_MB_bench"] == pytest.approx(
        jcm.bench_budget(2)["mshard_iter_MB_bench"])


def test_dryrun_entry_renders():
    """The single-device entry point: one color render of a 16x16 ray block
    through the tiny map, finite, with valid rays."""
    from loopy_slam_torch.parallel.dryrun import entry

    fn, args = entry("cpu")
    depth, var, color, valid = fn(*args)
    assert depth.shape == (256,) and color.shape == (256, 3)
    assert torch.isfinite(depth).all() and valid.any()


def ray_dp_draws(key, n, F, P, ppf_l, S, c, H, W, n_geo, n_col):
    """JAX's draws in make_sharded_optimize_map's chunk on device r (the
    pool key and every iteration key folded with r), in the port's order:
    the pool's rows (F, P) and cols (F, P); per iteration the picks
    (F, ppf) and the decode's noise."""
    kpool, k = jax.random.split(key)
    out = []
    for r in range(n):
        fk = jax.random.split(jax.random.fold_in(kpool, r), F)
        hw = [jax.random.split(fk[f]) for f in range(F)]
        out.append([jnp.stack([jax.random.randint(a, (P,), 0, H)
                               for a, _ in hw]),
                    jnp.stack([jax.random.randint(b, (P,), 0, W)
                               for _, b in hw])])
    for it in range(n_geo + n_col):
        k, kiter = jax.random.split(k)
        for r in range(n):
            kd, kr = jax.random.split(jax.random.fold_in(kiter, r))
            kg, kc = jax.random.split(kr)
            out[r] += [jax.random.randint(kd, (F, ppf_l), 0, P),
                       jax.random.normal(kg, (F * ppf_l * S, c))]
            if it >= n_geo:
                out[r].append(jax.random.normal(kc, (F * ppf_l * S, c)))
    return [[np.asarray(a) for a in d] for d in out]


def test_ray_dp_chunk_matches(tmp_path, session_run):
    """One ray-DP mapping chunk on the replicated map of frame 0 against
    make_sharded_optimize_map at n = 2 with its per-device draws
    replayed; both ranks end with the same decoders and features."""
    n = 2
    jdec.set_bf16_trunks(False)
    try:
        cfg, state, params, _, mopts, ropts, (kc, kd, kp) = chunk_scene()
        feat_mask = np.asarray(jpc.valid_mask(state))
        ppf, n_geo, n_col = 60, 3, 1
        lrs_geo, lrs_col = [0.001, 0.03, 0.0], [0.005, 0.005, 0.005]
        key = jax.random.PRNGKey(5)
        ppf_l = ppf // n
        draws = ray_dp_draws(key, n, 2, mopts.pixel_pool_factor * ppf_l,
                             ppf_l, ropts.n_surface, ropts.c_dim, mopts.H,
                             mopts.W, n_geo, n_col)
        g = state.grid
        inp = {"state": [np.asarray(a) for a in (
                   state.pos, state.feat, state.count, g.cell_data,
                   g.cell_fill, g.cell_size, g.n_dropped)],
               "params": jax.tree.map(np.asarray, params), "cfg": cfg,
               "feat_mask": feat_mask, "kc": kc, "kd": kd, "kp": kp,
               "draws": draws, "n_geo": n_geo, "n_col": n_col,
               "lrs_geo": lrs_geo, "lrs_col": lrs_col, "ppf": ppf,
               "mopts": fields(mopts, TMapperOptions),
               "ropts": fields(ropts, TRenderOptions)}
        pool = ThreadPoolExecutor(1)  # the port's ranks run meanwhile
        port = pool.submit(tmesh.launch, workers.ray_dp_chunk, n, inp,
                           device="cpu", timeout_s=120.0,
                           store_dir=str(tmp_path))
        mesh = make_mesh(n)
        step = make_sharded_optimize_map(mesh, mopts, ropts, ppf)
        trainable = {"dec": jax.tree.map(jnp.copy, params),
                     "feat": jnp.copy(state.feat)}
        args = replicate(mesh, (
            trainable, jadam.init(trainable), jdec.trainable_mask(params, cfg),
            jnp.asarray(feat_mask), state.pos, state.grid, jnp.asarray(kc),
            jnp.asarray(kd), jnp.asarray(kp), None, key, jnp.asarray(n_geo),
            jnp.asarray(n_col), jnp.asarray(lrs_geo), jnp.asarray(lrs_col),
            None, None, None, None, None))
        jt, _, jaux = step(*args)
        jfeat = np.asarray(jt["feat"])
        jdec_np = dict(leaves_with_names(jt["dec"]))
    finally:
        jdec.set_bf16_trunks(True)
    port = port.result()
    pool.shutdown()
    ja = [float(a) for a in jaux]
    for p in port:
        assert_chunk_close(p, ja, jfeat, jdec_np,
                           n_geo * lrs_geo[1] + n_col * lrs_col[1],
                           n_geo * lrs_geo[0] + n_col * lrs_col[0])
    np.testing.assert_array_equal(port[0]["feat"], port[1]["feat"])
    for name, a in port[0]["dec"].items():
        np.testing.assert_array_equal(a, port[1]["dec"][name])
    assert np.abs(jfeat - np.asarray(state.feat)).max() > 1e-3


def test_map_shard_session_two_ranks(session_run):
    """A tiny map-sharded session through the CLI on 2 ranks: the
    trajectory in band, no health-gate reject, both shards non-empty and
    summing to the gathered map, the same replicated state on both ranks,
    and rank 0's outputs."""
    from loopy_slam_torch.tools.eval_ate import evaluate_from_output

    fut, out = session_run
    st = fut.result()
    assert st["rmse"] < 0.015, st["rmse"]
    assert st["health_rejects"] == 0 and st["n"] == 6
    ranks = st["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["backend"] == "gloo" for r in ranks)
    shards = [r["shard_count"] for r in ranks]
    assert min(shards) > 0 and sum(shards) == st["n_points"] > 500
    assert ranks[0]["checksum"] == ranks[1]["checksum"]
    assert ranks[0]["collectives"]["ring"]["calls"] > 0
    assert evaluate_from_output(str(out))["rmse"] == pytest.approx(
        st["rmse"])
    assert not os.path.exists(os.path.join(out, ".mesh")) or not \
        os.listdir(os.path.join(out, ".mesh"))
