"""The port's geometry-trunk pretraining (loopy_slam_torch/tools/
pretrain_geo.py) against the JAX tool, on the CPU: one scene, 8 iterations
(4 geometry, 4 color), the tool's widths (120x160, 8 frames, 3000 rays
inserted a frame, 400 pixels a frame, capacity 2^16, table 2^17). The port
starts from JAX's initial decoders (convert) and takes JAX's draws
replayed (ReplayDraws), in the order the JAX tool makes them.

Tolerances:
  * the scene's loss terms within 1e-3 relative, f32 or bf16 trunks
    (measured 1e-6 with f32, 7e-5 with bf16).
  * the trained trunk, entry by entry: every entry within the summed
    learning-rate steps of both sides (2 x 8 x 0.001), and 97 % of
    entries within 1e-4 with f32 trunks (measured 98.4 %), 70 % with
    bf16 (measured 78.7 %: a last-bit difference can flip an input's
    bf16 rounding). Not every entry within 1e-4: the trunk trains here,
    and Adam's first steps are lr * sign(g), so a near-zero gradient
    whose sign differs in the last bits (XLA's and torch's sin at
    |x @ B| ~ 100, reduction orders) moves that entry a full step on one
    side only (tests/test_torch_mapping.py's parity limit; measured max
    2e-3 with f32).
  * the trained trunk as a function: occupancy logits of 20,000 points
    and features through the JAX-trained and the port-trained trunk
    (f32 evaluation) within 1 % (f32 training) or 5 % (bf16) of the
    logits' largest magnitude, and their median difference under 1 % or
    2 % of the median distance between the trained and the initial
    trunk's logits (measured 0.05 % and 0.5 %).
  * the pickle: the keys, shapes and dtypes of pretrained/geo_decoder.pkl,
    every key a parameter of the port's dec.geo, and LoopySLAM loading it
    through pretrained_decoders.middle_fine.
Every run writes under tmp_path; the shipped trunk is never touched.
"""

import copy
import hashlib
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from loopy_slam_torch.ops.draws import ReplayDraws
from loopy_slam_torch.tools import pretrain_geo as tpre
from loopy_slam_tpu.mapping import mapper as jmapper
from loopy_slam_tpu.models import decoder as jdec
from loopy_slam_tpu.tools import pretrain_geo as jpre
from test_torch_mapping import leaves_with_names, mapper_draws
from torch_cpu import torch_cpu  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "pretrained", "geo_decoder.pkl")
SEED, SCENES, ITERS = 7, 1, 8


def jax_draws(cfg, seed, n_scenes, iters):
    """The draws the JAX tool makes, in the port's order: per scene, each
    inserted frame's rows, cols and feature normals, then the mapping
    call's pool and per-iteration draws."""
    from loopy_slam_tpu.mapping.point_cloud import MapOptions

    mo = MapOptions.from_cfg(cfg)
    H, W = cfg["cam"]["H"], cfg["cam"]["W"]
    S = cfg["rendering"]["N_surface"]
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_scenes):
        key, _ka = jax.random.split(key)
        for _ in range(0, cfg["data"]["n_frames"], 2):
            key, kadd = jax.random.split(key)
            ks, ka = jax.random.split(kadd)
            kh, kw = jax.random.split(ks)
            out += [jax.random.randint(kh, (tpre.ADD_RAYS,), 0, H),
                    jax.random.randint(kw, (tpre.ADD_RAYS,), 0, W),
                    jax.random.normal(ka, (tpre.ADD_RAYS * mo.N_add,
                                           2 * mo.c_dim))]
        key, km = jax.random.split(key)
        F = len(range(0, cfg["data"]["n_frames"], 2))
        out += mapper_draws(km, F, cfg["mapping"]["pixel_pool_factor"]
                            * tpre.PIXELS, tpre.PIXELS, S, mo.c_dim, H, W,
                            iters // 2, iters // 2)
    return [np.asarray(a) for a in out]


def run_both(monkeypatch, bf16: bool):
    """(JAX's trunk, JAX's loss terms, the port's trunk, its records)."""
    from loopy_slam_tpu.config import DEFAULTS, update_recursive

    jcfg = copy.deepcopy(DEFAULTS)
    update_recursive(jcfg, copy.deepcopy(tpre.OVERLAY))
    jdec.set_bf16_trunks(bf16)
    try:
        init = jax.tree.map(np.asarray, jdec.init_decoders(
            jax.random.PRNGKey(SEED), jcfg))
        auxes = []
        opt = jmapper.optimize_map

        def recording(*a, **kw):
            res = opt(*a, **kw)
            auxes.append([float(x) for x in res[2]])
            return res
        monkeypatch.setattr(jmapper, "optimize_map", recording)
        jgeo = jpre.pretrain(SCENES, ITERS, SEED, verbose=False)
    finally:
        jdec.set_bf16_trunks(True)
    config = tpre.pretrain_config

    def port_config():
        cfg = config()
        cfg["model"]["bf16_trunks"] = bf16
        return cfg
    monkeypatch.setattr(tpre, "pretrain_config", port_config)
    tgeo, scenes = tpre.pretrain(
        SCENES, ITERS, SEED, verbose=False, device="cpu",
        draw=ReplayDraws(jax_draws(jcfg, SEED, SCENES, ITERS), "cpu"),
        init_params=init)
    g, c, n = auxes[0]
    jterms = [g / max(n, 1), c / max(n, 1), n]
    return init, jgeo, jterms, tgeo, scenes


def _terms(rec):
    return [rec["geo_loss_pixel"], rec["color_loss_pixel"], rec["rays"]]


def _logits(geo, col):
    """Occupancy logits of fixed points and features through a trunk."""
    from loopy_slam_torch.convert import decoders_from_numpy
    from loopy_slam_torch.models.decoder import geo_forward

    rng = np.random.default_rng(0)
    p = torch.as_tensor(rng.uniform(-2.5, 2.5, (20000, 3)),
                        dtype=torch.float32)
    c = torch.as_tensor(0.1 * rng.standard_normal((20000, 32)),
                        dtype=torch.float32)
    dec = decoders_from_numpy({"geo": geo, "col": col}, "cpu",
                              bf16_trunks=False)
    with torch.no_grad():
        return geo_forward(dec.geo, p, c).numpy()


def _check(monkeypatch, bf16, entry_share, fn_max, fn_median):
    init, jgeo, jterms, tgeo, scenes = run_both(monkeypatch, bf16)
    assert len(scenes) == SCENES
    t = _terms(scenes[0])
    assert t[2] == jterms[2] > 0
    np.testing.assert_allclose(t[:2], jterms[:2], rtol=1e-3)
    jl, tl = dict(leaves_with_names(jgeo)), dict(leaves_with_names(tgeo))
    assert sorted(jl) == sorted(tl)
    for name, want in jl.items():
        assert tl[name].shape == want.shape
        assert tl[name].dtype == np.float32
    diff = np.concatenate([np.abs(tl[n] - jl[n]).ravel() for n in jl])
    assert diff.max() <= 2 * ITERS * tpre.LRS_GEO[0]
    assert np.mean(diff <= 1e-4) >= entry_share
    lj, lt = _logits(jgeo, init["col"]), _logits(tgeo, init["col"])
    l0 = _logits(init["geo"], init["col"])
    assert np.abs(lt - lj).max() <= fn_max * np.abs(lj).max()
    assert np.median(np.abs(lt - lj)) <= fn_median * np.median(
        np.abs(lj - l0))


def test_pretrain_matches_jax_f32(monkeypatch):
    _check(monkeypatch, False, 0.97, 0.01, 0.01)


def test_pretrain_matches_jax_bf16(monkeypatch):
    _check(monkeypatch, True, 0.70, 0.05, 0.02)


def test_pretrain_cli_writes_a_loadable_trunk(tmp_path):
    """The CLI's pickle has the shipped trunk's keys, shapes and dtypes,
    every entry finite; each key names a parameter of dec.geo; and a
    session's LoopySLAM loads it through pretrained_decoders.middle_fine.
    The shipped file is untouched."""
    from loopy_slam_torch.config import DEFAULTS
    from loopy_slam_torch.slam import LoopySLAM, _flatten

    with open(SHIPPED, "rb") as f:
        before = hashlib.sha256(f.read()).hexdigest()
    out = str(tmp_path / "geo.pkl")
    geo, scenes = tpre.main(["--scenes", "1", "--iters", "2", "--out", out,
                             "--device", "cpu"])
    assert np.isfinite([scenes[0]["geo_loss_pixel"],
                        scenes[0]["color_loss_pixel"]]).all()
    with open(out, "rb") as f:
        got = dict(_flatten(pickle.load(f)))
    with open(SHIPPED, "rb") as f:
        want = dict(_flatten(pickle.load(f)))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].shape == np.asarray(arr).shape
        assert got[name].dtype == np.asarray(arr).dtype
        assert np.isfinite(got[name]).all()
    cfg = copy.deepcopy(DEFAULTS)
    cfg["pretrained_decoders"] = {"middle_fine": out}
    cfg["cam"].update({"H": 60, "W": 80, "fx": 60.0, "fy": 60.0,
                       "cx": 39.5, "cy": 29.5})
    cfg["data"]["n_frames"] = 2
    cfg["data"]["output"] = str(tmp_path / "run")
    slam = LoopySLAM(cfg, output=str(tmp_path / "run"), device="cpu")
    try:
        params = dict(slam.dec.geo.named_parameters())
        assert set(got) <= set(params)
        for name, arr in got.items():
            np.testing.assert_array_equal(
                params[name].detach().numpy(), arr)
    finally:
        slam.close()
    with open(SHIPPED, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == before
