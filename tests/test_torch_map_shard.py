"""The port's map sharding (loopy_slam_torch/parallel/map_shard.py) against
the JAX package's shard_map on the same number of the conftest's virtual
CPU devices, at n = 2 and n = 4 ranks over gloo on the CPU.

The port's ranks are spawned processes (tests/torch_rank_workers.py,
which imports no jax); the same numpy inputs go to both sides, and the
port replays JAX's per-device draws (the key folded with the device
index). Tolerances:
  * owner ids, insertion (per-shard pos, feat, count and hash grid), the
    ring k-NN's D/I/owner/neighbor_num and the ring fetch: bit-equal;
  * the ring k-NN against the port's single-map query: sorted D within
    rtol 1e-5, the fetched positions' distances within 3e-4 (the JAX
    package's own map-shard test);
  * feature gradients through the ring fetch: within 1e-6 of JAX's VJP,
    and nothing outside a shard's valid rows;
  * the sharded eval_points: within 1e-5 (f32 trunks on both sides).
The ring k-NN runs with per-query radii at n = 2 and with a scalar radius
at n = 4, and the sharded eval_points at n = 2 only: each k-NN hop on the
JAX side is a Pallas kernel traced in interpret mode (~2.3 s of compile
each on an 8-core x86 CPU);
  * the PGO transform within 1e-6 (a 3x3 matmul in another summation
    order), grow/scatter/gather bit-equal;
  * a map-shard mapping chunk as test_torch_mapping holds its single-device
    chunk: loss terms within 1e-3 relative, 99.5% of feature and decoder
    entries within 1e-4, every entry within both sides' summed learning
    rate steps. One leaf is held by the last bound only: geo.B, the
    geometry Fourier embedder (279 entries up to |64|). A ReLU
    pre-activation of the geometry trunk within rounding of zero takes
    another sign in one float32 run than in the other, which moves geo.B's
    whole gradient by up to ~1e-3, and Adam's normalised step turns that
    into lr-sized steps on its small entries: the port's single-device
    chunk against JAX's on this scene puts 0-42% of its entries beyond
    1e-4 over keys 0-7 (key 4, test_torch_mapping's own, 0.36%), and each
    package's float32 chunk lies as far from its float64 chunk, so at 279
    entries the 99.5% rule would hold it only by chance.
    test_torch_mapping.py holds geo.B's first gradient instead, within
    half the float32-vs-float64 gap at keys 0-7.
"""

from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_rank_workers as workers
from conftest import small_cfg
from loopy_slam_torch.mapping.mapper import MapperOptions as TMapperOptions
from loopy_slam_torch.mapping.point_cloud import MapOptions as TMapOptions
from loopy_slam_torch.models.renderer import RenderOptions as TRenderOptions
from loopy_slam_torch.ops import knn as tknn
from loopy_slam_torch.parallel.mesh import launch
from loopy_slam_tpu.mapping import mapper as jmapper
from loopy_slam_tpu.mapping import point_cloud as jpc
from loopy_slam_tpu.models import decoder as jdec
from loopy_slam_tpu.models.renderer import RenderOptions
from loopy_slam_tpu.ops import adam as jadam
from loopy_slam_tpu.parallel import map_shard as jms
from loopy_slam_tpu.utils.datasets import Synthetic

TABLE, M, CELL, RADIUS, CAP_L, C_DIM, K = 2 ** 14, 16, 0.4, 0.35, 1024, 32, 8
AX = jms.AXIS
NS = [2, 4]


def fields(nt, cls):
    return {f: getattr(nt, f) for f in cls._fields}


def stacked(smap, r):
    g = smap.grid
    return {"pos": np.asarray(smap.pos)[r], "feat": np.asarray(smap.feat)[r],
            "count": int(np.asarray(smap.count)[r]),
            "cell_data": np.asarray(g.cell_data)[r],
            "cell_fill": np.asarray(g.cell_fill)[r],
            "n_dropped": int(np.asarray(g.n_dropped)[r])}


def assert_shard_equal(got, want, pos_atol=0.0):
    assert got["count"] == want["count"]
    assert got["n_dropped"] == want["n_dropped"]
    if pos_atol:
        np.testing.assert_allclose(got["pos"], want["pos"], atol=pos_atol,
                                   rtol=0)
    else:
        np.testing.assert_array_equal(got["pos"], want["pos"])
        np.testing.assert_array_equal(got["cell_data"].view(np.int32),
                                      want["cell_data"].view(np.int32))
    np.testing.assert_array_equal(got["feat"], want["feat"])
    np.testing.assert_array_equal(got["cell_fill"], want["cell_fill"])


@pytest.fixture(scope="module", params=NS)
def prims(request, tmp_path_factory):
    """JAX's and the port's results on one scene at n ranks (per-query
    radii and eval_points at n = 2, a scalar radius at n = 4)."""
    n = request.param
    extras = n == 2
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.0, 1.0, size=(1500, 3)).astype(np.float32)
    feats = (rng.normal(size=(1500, 2 * C_DIM)) * 0.1).astype(np.float32)
    Q = 16 * n
    q = rng.uniform(-0.9, 0.9, size=(Q, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.35, size=(Q,)).astype(np.float32)
    cot = rng.normal(size=(Q, K, 2 * C_DIM + 3)).astype(np.float32)
    q_eval = pts[rng.integers(0, 1500, size=Q)] + np.float32(0.01)
    ijk = np.concatenate([
        rng.integers(-40, 40, size=(200, 3)),
        rng.integers(-2 ** 31, 2 ** 31 - 1, size=(200, 3))]).astype(np.int32)
    N = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.1), np.sin(0.1)
    N[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    N[:3, 3] = [0.05, -0.02, 0.03]

    ropts = RenderOptions(nn_num=K, min_nn_num=1, radius_query=RADIUS,
                          table_size=TABLE, max_per_cell=M,
                          encode_rel_pos_in_col=True)
    mopts = jpc.MapOptions(c_dim=C_DIM, cell_size=CELL, table_size=TABLE,
                           max_per_cell=M)
    params = jdec.init_decoders(jax.random.PRNGKey(1), small_cfg())
    key = jax.random.PRNGKey(3)
    eval_draws = []
    for r in range(n):
        kg, kc = jax.random.split(jax.random.fold_in(key, r))
        eval_draws.append([np.asarray(jax.random.normal(kg, (16, C_DIM))),
                           np.asarray(jax.random.normal(kc, (16, C_DIM)))])
    inp = {"ijk": ijk, "pts": pts, "feats": feats, "q": q, "radii": radii,
           "radius": RADIUS, "k": K, "cap_l": CAP_L, "cot": cot,
           "q_eval": q_eval, "eval_draws": eval_draws, "N": N,
           "extras": extras, "params": jax.tree.map(np.asarray, params),
           "mopts": fields(mopts, TMapOptions),
           "ropts": fields(ropts, TRenderOptions)}
    # the port's ranks need none of JAX's results: they run meanwhile
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(
            launch, workers.primitives, n, inp, device="cpu",
            timeout_s=120.0,
            store_dir=str(tmp_path_factory.mktemp(f"mesh{n}")))
        jax_out = jax_prims(n, extras, inp, params, ropts, mopts, key)
        return {"n": n, "jax": jax_out, "port": port.result(), "inp": inp}


def jax_prims(n, extras, inp, params, ropts, mopts, key):
    """JAX's side of the prims fixture (f32 trunks)."""
    pts, feats, q, radii, cot, q_eval, ijk, N = (
        inp[k] for k in ("pts", "feats", "q", "radii", "cot", "q_eval",
                         "ijk", "N"))
    jdec.set_bf16_trunks(False)
    try:
        mesh = jms.make_mesh(n)
        smap = jms.init_sharded_map(mesh, CAP_L, C_DIM, CELL, TABLE, M)
        smap = jms.make_shard_insert(mesh, CELL, TABLE)(
            smap, jnp.asarray(pts), jnp.asarray(feats),
            jnp.ones(len(pts), bool))

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(jms.SMAP_SPEC, P(AX), P(AX)),
                 out_specs=(P(AX),) * 5, check_vma=False)
        def ring(smap_st, q_l, rq_l):
            sl = jms._local(smap_st)
            a = jms.ring_knn(sl, q_l, K, rq_l if extras else RADIUS, TABLE,
                             M, n)
            return (*a, jms.ring_fetch(sl, a[1], a[2], n))

        out = [np.asarray(x) for x in ring(smap, jnp.asarray(q),
                                           jnp.asarray(radii))]

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(jms.SMAP_SPEC, P(AX), P(AX)), out_specs=P(AX),
                 check_vma=False)
        def fetch(smap_st, I, O):
            return jms.ring_fetch(jms._local(smap_st), I, O, n)

        grad = np.asarray(jax.grad(lambda f: jnp.sum(fetch(
            smap._replace(feat=f), jnp.asarray(out[1]),
            jnp.asarray(out[2])) * cot))(smap.feat))
        ev = (jms.make_sharded_eval_points(mesh, ropts, "color")(
            params, smap, jnp.asarray(q_eval), key) if extras else ())
        jax_out = {
            "owner_cells": np.asarray(jms.owner_of_cells(jnp.asarray(ijk), n)),
            "owner_points": np.asarray(jms.owner_of_points(
                jnp.asarray(pts), CELL, n)),
            "insert": [stacked(smap, r) for r in range(n)],
            "knn": out[0:4], "fetch": out[4], "feat_grad": grad,
            "eval": [np.asarray(x) for x in ev],
            "transform": jms.make_shard_transform(mesh, mopts)(
                smap, jnp.asarray(N)),
            "grow": jms.grow_sharded(mesh, smap, 2 * CAP_L, mopts),
            "gather": jms.gather_host(smap),
            "scatter": jms.scatter_from_host(mesh, pts, feats, CAP_L, mopts),
        }
        for name in ("transform", "grow", "scatter"):
            jax_out[name] = [stacked(jax_out[name], r) for r in range(n)]
        return jax_out
    finally:
        jdec.set_bf16_trunks(True)


def test_owner_ids_bit_equal(prims):
    """Cell owners, small, negative and int32-extreme cells (wrap-around),
    on the device and on the host, as JAX's."""
    from loopy_slam_torch.parallel.map_shard import owner_of_points_np

    j, n = prims["jax"], prims["n"]
    for p in prims["port"]:
        np.testing.assert_array_equal(p["owner_cells"], j["owner_cells"])
        np.testing.assert_array_equal(p["owner_points"], j["owner_points"])
    np.testing.assert_array_equal(
        owner_of_points_np(prims["inp"]["pts"], CELL, n), j["owner_points"])
    assert len(np.unique(j["owner_cells"])) == n


def test_insertion_partitions_points(prims):
    j, inp = prims["jax"], prims["inp"]
    counts = [p["insert"]["count"] for p in prims["port"]]
    assert sum(counts) == len(inp["pts"]) and min(counts) > 0
    for r, p in enumerate(prims["port"]):
        assert_shard_equal(p["insert"], j["insert"][r])
        mine = j["owner_points"] == r
        np.testing.assert_array_equal(p["insert"]["pos"][:counts[r]],
                                      inp["pts"][mine])


def test_ring_knn_bit_equal(prims):
    """D, I, owner and neighbor_num of every rank's queries, at a scalar and
    at per-query radii."""
    n, j = prims["n"], prims["jax"]
    for r, p in enumerate(prims["port"]):
        sl = slice(r * 16, (r + 1) * 16)
        for got, want in zip(p["knn"], j["knn"]):
            np.testing.assert_array_equal(got, want[sl])
    assert (np.concatenate([p["knn"][3] for p in prims["port"]]) > 0).any()
    owners = np.concatenate([p["knn"][2] for p in prims["port"]])
    assert set(np.unique(owners[owners >= 0])) == set(range(n))


def test_ring_knn_matches_single_map(prims):
    """The ring's distances are the single-map query's (the port's own
    knn.query over every point, at the same radii), and the fetched
    positions reproduce them."""
    import torch

    inp = prims["inp"]
    pts = torch.as_tensor(inp["pts"])
    cap = 4096
    pos = torch.zeros((cap, 3))
    pos[:len(pts)] = pts
    grid = tknn.build(pos, torch.arange(cap) < len(pts), CELL, TABLE, M)
    rad = torch.as_tensor(inp["radii"]) if inp["extras"] else RADIUS
    D1, _, nn1 = tknn.query(grid, pos, torch.as_tensor(inp["q"]), K, rad)
    D1 = D1.numpy()
    D = np.concatenate([p["knn"][0] for p in prims["port"]])
    np.testing.assert_array_equal(
        np.concatenate([p["knn"][3] for p in prims["port"]]), nn1.numpy())
    np.testing.assert_allclose(np.sort(D, 1), np.sort(D1, 1), rtol=1e-5)
    both = np.concatenate([p["fetch"] for p in prims["port"]])
    d2 = ((both[..., 2 * C_DIM:] - inp["q"][:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(np.sort(np.where(D < 1e9, d2, 1e10), 1),
                               np.sort(D1, 1), rtol=3e-4)


def test_ring_fetch_bit_equal(prims):
    for r, p in enumerate(prims["port"]):
        np.testing.assert_array_equal(p["fetch"],
                                      prims["jax"]["fetch"][r * 16:
                                                            (r + 1) * 16])


def test_feature_grads_routed_to_owner_shards(prims):
    j = prims["jax"]
    total = 0.0
    for r, p in enumerate(prims["port"]):
        np.testing.assert_allclose(p["feat_grad"], j["feat_grad"][r],
                                   atol=1e-6, rtol=0)
        cnt = p["insert"]["count"]
        assert not p["feat_grad"][cnt:].any()
        total += np.abs(p["feat_grad"]).sum()
    assert total > 0


@pytest.mark.parametrize("prims", [2], indirect=True)
def test_sharded_eval_points(prims):
    occ, rgb, hn = prims["jax"]["eval"]
    for r, p in enumerate(prims["port"]):
        sl = slice(r * 16, (r + 1) * 16)
        np.testing.assert_array_equal(p["eval"][2], hn[sl])
        np.testing.assert_allclose(p["eval"][0], occ[sl], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(p["eval"][1], rgb[sl], rtol=1e-5,
                                   atol=1e-5)
    assert hn.all()


def test_transform_grow_scatter_gather(prims):
    j = prims["jax"]
    for r, p in enumerate(prims["port"]):
        assert_shard_equal(p["transform"], j["transform"][r], pos_atol=1e-6)
        assert_shard_equal(p["grow"], j["grow"][r])
        assert_shard_equal(p["scatter"], j["scatter"][r])
        pos, feat, counts = p["gather"]
        np.testing.assert_array_equal(pos, j["gather"][0])
        np.testing.assert_array_equal(feat, j["gather"][1])
        np.testing.assert_array_equal(counts, j["gather"][2])


def shard_chunk_draws(key, n, F, ppf_l, S, c, H, W, n_geo, n_col):
    """JAX's draws in make_map_shard_optimize's chunk on device r (no ray
    pool: fresh rays and a ring decode every iteration), in the port's
    order: per iteration rows (F, ppf) and cols (F, ppf), then the
    decode's geometry noise and, in the color stage, its color noise."""
    out = [[] for _ in range(n)]
    k = key
    for it in range(n_geo + n_col):
        k, kiter = jax.random.split(k)
        for r in range(n):
            ks, kr = jax.random.split(jax.random.fold_in(kiter, r))
            fk = jax.random.split(ks, F)
            hw = [jax.random.split(fk[f]) for f in range(F)]
            out[r] += [jnp.stack([jax.random.randint(a, (ppf_l,), 0, H)
                                  for a, _ in hw]),
                       jnp.stack([jax.random.randint(b, (ppf_l,), 0, W)
                                  for _, b in hw])]
            kg, kc = jax.random.split(kr)
            out[r].append(jax.random.normal(kg, (F * ppf_l * S, c)))
            if it >= n_geo:
                out[r].append(jax.random.normal(kc, (F * ppf_l * S, c)))
    return [[np.asarray(a) for a in d] for d in out]


def chunk_scene():
    """Frames 0 and 2 of small_cfg's room, a JAX map of frame 0 and f32
    decoders (the caller sets f32 trunks)."""
    cfg = small_cfg()
    cfg["model"]["bf16_trunks"] = False
    ds = Synthetic(cfg)
    _, color, depth, c2w = ds[0]
    mopts_map = jpc.MapOptions.from_cfg(cfg)
    mopts = jmapper.MapperOptions.from_cfg(cfg)
    ropts = RenderOptions.from_cfg(cfg)
    state = jpc.init_map(mopts_map)
    params = jdec.init_decoders(jax.random.PRNGKey(0), cfg)
    state, _ = jmapper.add_points_from_frame(
        state, jnp.asarray(color), jnp.asarray(depth), jnp.asarray(c2w),
        jnp.asarray(c2w), jax.random.PRNGKey(1), mopts_map, mopts, 2000,
        overlap=None)
    frames = [ds[i] for i in (0, 2)]
    win = [np.stack([f[i] for f in frames]) for i in (1, 2, 3)]
    return cfg, state, params, mopts_map, mopts, ropts, win


def assert_chunk_close(port, ja, jfeat_by_rank, jdec_np, lr_feat, lr_dec):
    """test_torch_mapping's chunk tolerances."""
    assert port["aux"][2] == ja[2] > 0
    np.testing.assert_allclose(port["aux"][:2], ja[:2], rtol=1e-3)
    pairs = [("feat", port["feat"], jfeat_by_rank, lr_feat)]
    pairs += [(name, p, jdec_np[name], lr_dec)
              for name, p in port["dec"].items()]
    for name, a, b, lr_sum in pairs:
        diff = np.abs(a - b)
        if name != "geo.B":  # see the module docstring
            assert np.mean(diff > 1e-4) < 0.005, name
        assert diff.max() <= 2 * lr_sum + 1e-6, name


def leaves_with_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves_with_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_names(v, f"{prefix}{i}.")]
    return [(prefix[:-1], np.asarray(tree))]


def test_map_shard_chunk_matches(tmp_path):
    """One map-shard mapping chunk (3 geometry + 1 color iterations, 30
    rays a frame a rank, the decode through the ring every iteration) on
    the scattered map of frame 0, against make_map_shard_optimize at n = 2
    with its per-device draws replayed; then, on the port's side, the
    ring probe of sample_near_pcl and a chunk with it and BA."""
    n = 2
    jdec.set_bf16_trunks(False)
    try:
        cfg, state, params, mopts_map, mopts, ropts, (kc, kd, kp) = \
            chunk_scene()
        cnt = int(state.count)
        pos, feat = np.asarray(state.pos)[:cnt], np.asarray(state.feat)[:cnt]
        cap_l = 4096
        mesh = jms.make_mesh(n)
        smap = jms.scatter_from_host(mesh, pos, feat, cap_l, mopts_map)
        ppf, n_geo, n_col = 60, 3, 1
        lrs_geo, lrs_col = [0.001, 0.03, 0.0], [0.005, 0.005, 0.005]
        key = jax.random.PRNGKey(4)
        draws = shard_chunk_draws(key, n, 2, ppf // n, ropts.n_surface,
                                  ropts.c_dim, mopts.H, mopts.W, n_geo, n_col)
        probe_pts = (pos[np.random.default_rng(1).integers(0, cnt, 200)]
                     + np.float32(0.05)).astype(np.float32)
        probe_pts = np.concatenate([probe_pts, probe_pts + np.float32(2.0)])
        inp = {"pos": pos, "feat": feat, "cap_l": cap_l,
               "probe_pts": probe_pts,
               "params": jax.tree.map(np.asarray, params), "cfg": cfg,
               "kc": kc, "kd": kd, "kp": kp, "draws": draws, "n_geo": n_geo,
               "n_col": n_col, "lrs_geo": lrs_geo, "lrs_col": lrs_col,
               "ppf": ppf, "mopts_map": fields(mopts_map, TMapOptions),
               "mopts": fields(mopts, TMapperOptions),
               "ropts": fields(ropts, TRenderOptions)}
        pool = ThreadPoolExecutor(1)  # the port's ranks run meanwhile
        port = pool.submit(launch, workers.map_shard_chunk, n, inp,
                           device="cpu", timeout_s=120.0,
                           store_dir=str(tmp_path))
        opt = jms.make_map_shard_optimize(mesh, mopts, ropts, ppf)
        s_feat_mask = jnp.arange(cap_l)[None, :] < smap.count[:, None]
        trainable = {"dec": jax.tree.map(jnp.copy, params),
                     "feat": jnp.copy(smap.feat)}
        jt, _, jaux = opt(
            trainable, jadam.init(trainable),
            jdec.trainable_mask(params, cfg), s_feat_mask, smap.pos,
            smap.count, smap.grid, jnp.asarray(kc), jnp.asarray(kd),
            jnp.asarray(kp), None, key, jnp.asarray(n_geo),
            jnp.asarray(n_col), jnp.asarray(lrs_geo), jnp.asarray(lrs_col),
            None)
        jfeat = np.asarray(jt["feat"])
        jdec_np = dict(leaves_with_names(jt["dec"]))
    finally:
        jdec.set_bf16_trunks(True)
    port = port.result()
    pool.shutdown()
    ja = [float(a) for a in jaux]
    for r, p in enumerate(port):
        assert_chunk_close(p, ja, jfeat[r],
                           jdec_np, n_geo * lrs_geo[1] + n_col * lrs_col[1],
                           n_geo * lrs_geo[0] + n_col * lrs_col[0])
        assert np.abs(jfeat[r] - np.asarray(smap.feat)[r]).max() > 1e-3
    # the replicated decoders agree across the ranks
    for name, a in port[0]["dec"].items():
        np.testing.assert_array_equal(a, port[1]["dec"][name])
    # sample_near_pcl's ring probe sees every shard (the single-map
    # probe's answer), and a chunk with it and bundle adjustment trains
    # the same replicated poses on both ranks (the oldest row fixed)
    for p in port:
        assert p["probe_equal"] and 0 < p["probe_hits"] < 400
        ba = p["ba"]
        assert ba["finite"] and np.isfinite(ba["aux"]).all()
        assert ba["aux"][2] > 0
        np.testing.assert_array_equal(ba["cams"][0], ba["cams0"][0])
        assert np.abs(ba["cams"][1] - ba["cams0"][1]).max() > 0
    np.testing.assert_array_equal(port[0]["ba"]["cams"], port[1]["ba"]["cams"])
