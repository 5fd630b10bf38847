"""The port's decoders and renderer against the JAX package, on the CPU.

Weights go through convert.py; both sides get the same inputs and the
same noise draws (ops/draws.ReplayDraws). Tolerances:
  * f32 trunks: 1e-4 relative (1e-6 absolute floor, scaled to the
    quantity) on values and grads: float32 on both sides; the difference
    is the summation order inside matmuls and reductions and libm's last
    bit, amplified by Fourier phases of hundreds of radians (a 1-ulp
    change of a sample position moves a phase by ~1e-5 rad).
  * bf16 trunks: 2e-2 relative on values and grads (absolute floor scaled
    to the quantity): an f32-level difference upstream can flip the bf16
    rounding of a trunk input (2^-8 relative), and JAX also rounds the
    trunk's input gradients to bf16 at other places than torch's autograd.
    That band alone would also pass f32 trunks, so the bf16 cases also
    require the port's values to lie, in mean absolute difference, at most
    BF16_SEPARATION times as far from JAX's bf16 values as JAX's own f32
    values do (measured: 4e-6 to 0.03 with the emulation, about 1 with f32
    trunks).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loopy_slam_torch.convert import decoders_from_numpy, decoders_to_numpy
from loopy_slam_torch.models import decoder as tdec
from loopy_slam_torch.models import renderer as trend
from loopy_slam_torch.ops import camera as tcam
from loopy_slam_torch.ops import knn as tknn
from loopy_slam_torch.ops.draws import ReplayDraws
from loopy_slam_tpu.config import DEFAULTS
from loopy_slam_tpu.models import decoder as jdec
from loopy_slam_tpu.models import renderer as jrend
from loopy_slam_tpu.ops import camera as jcam
from loopy_slam_tpu.ops import knn as jknn
from torch_cpu import torch_cpu  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_cpu")

TOL = {False: dict(rtol=1e-4, atol=1e-6, grad_rtol=1e-4),
       True: dict(rtol=2e-2, atol=1e-3, grad_rtol=2e-2)}
BF16_SEPARATION = 0.1


@pytest.fixture
def bf16_mode():
    """Set the JAX package's process-wide trunk mode; restore it after."""
    yield jdec.set_bf16_trunks
    jdec.set_bf16_trunks(True)


def jax_params(seed=0):
    return jdec.init_decoders(jax.random.PRNGKey(seed), DEFAULTS)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def t(a):
    return torch.as_tensor(np.array(a))


def port_render_options(ropts):
    """The port's RenderOptions from JAX's (the port has no table fields:
    its k-NN reads the table's shape from the grid)."""
    return trend.RenderOptions(**{f: getattr(ropts, f)
                                  for f in trend.RenderOptions._fields})


def leaves_with_names(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += leaves_with_names(v, f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_names(v, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]


def assert_bf16_emulated(port, jax_bf16, jax_f32):
    """The port's bf16-trunk values are far nearer JAX's bf16 values than
    JAX's f32 values are (mean absolute difference): the bf16 rounding of
    the trunk operands is really emulated."""
    port, bf, f32 = (np.asarray(x, np.float64) for x in
                     (port, jax_bf16, jax_f32))
    gap = np.abs(f32 - bf).mean()
    assert gap > 0
    assert np.abs(port - bf).mean() <= BF16_SEPARATION * gap


def assert_close_scaled(a, b, rtol, floor):
    """|a - b| <= rtol * |b| + floor * max|b| (per-quantity absolute floor)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=floor * scale)


def test_convert_roundtrip_and_pretrained_pickle():
    tree = to_np(jax_params())
    dec = decoders_from_numpy(tree, "cpu")
    back = decoders_to_numpy(dec)
    names = dict(leaves_with_names(tree))
    got = dict(leaves_with_names(back))
    assert names.keys() == got.keys()
    for k in names:
        np.testing.assert_array_equal(got[k], names[k])
    assert tuple(dec.geo.lin[0].w.shape) == (93, 32)
    with open("pretrained/geo_decoder.pkl", "rb") as f:
        geo = pickle.load(f)
    dec2 = decoders_from_numpy({"geo": geo, "col": tree["col"]}, "cpu")
    np.testing.assert_array_equal(
        decoders_to_numpy(dec2)["geo"]["lin"][3]["w"], geo["lin"][3]["w"])
    # the mapper's trainable mask matches the JAX mask leaf for leaf
    jm = dict(leaves_with_names(to_np(jdec.trainable_mask(
        jax_params(), DEFAULTS))))
    tm = tdec.trainable_mask(dec, DEFAULTS)
    for name, on in tm.items():
        assert bool(np.all(jm[name] == 1)) == on, name
        assert bool(np.all(jm[name] == 0)) == (not on), name


@pytest.mark.parametrize("bf16", [False, True])
def test_mlp_forwards(rng, bf16_mode, bf16):
    bf16_mode(bf16)
    tol = TOL[bf16]
    params = jax_params(1)
    dec = decoders_from_numpy(to_np(params), "cpu", bf16_trunks=bf16)
    p = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    c = rng.normal(scale=0.1, size=(300, 32)).astype(np.float32)
    rel = rng.uniform(-0.1, 0.1, (300, 8, 3)).astype(np.float32)
    f8 = rng.normal(scale=0.1, size=(300, 8, 32)).astype(np.float32)
    with torch.no_grad():
        outs = [tdec.geo_forward(dec.geo, t(p), t(c)),
                tdec.col_forward(dec.col, t(p), t(c)),
                tdec.neighbor_transform(dec.col, t(f8), t(rel))]

    def jax_refs():
        return [jdec.geo_forward(params["geo"], jnp.asarray(p),
                                 jnp.asarray(c)),
                jdec.col_forward(params["col"], jnp.asarray(p),
                                 jnp.asarray(c)),
                jdec.neighbor_transform(params["col"], jnp.asarray(f8),
                                        jnp.asarray(rel))]

    refs = jax_refs()
    for a, b in zip(outs, refs):
        assert_close_scaled(a, b, tol["rtol"], tol["atol"])
    if bf16:
        bf16_mode(False)
        for a, b, f in zip(outs, refs, jax_refs()):
            assert_bf16_emulated(a, b, f)
    x = rng.normal(scale=40, size=(400,)).astype(np.float32)
    np.testing.assert_allclose(tdec.softplus100(t(x)).numpy(),
                               np.asarray(jdec.softplus100(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(
        trend.soft_clamp_logits(t(x)).numpy(),
        np.asarray(jrend.soft_clamp_logits(jnp.asarray(x))), rtol=1e-6)


def _scene(rng, n_pts=600, n_rays=24, S=5):
    pos = np.zeros((1024, 3), np.float32)
    pos[:n_pts] = rng.uniform(-0.6, 0.6, (n_pts, 3))
    pos[:n_pts, 2] -= 1.5
    valid = np.arange(1024) < n_pts
    feats = rng.normal(scale=0.1, size=(1024, 64)).astype(np.float32)
    cam7 = np.array([1.0, 0.01, -0.02, 0.005, 0.02, -0.01, 0.03], np.float32)
    i = rng.uniform(2, 14, n_rays).astype(np.float32)
    j = rng.uniform(2, 10, n_rays).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 2.0, (n_rays, S)), 1).astype(np.float32)
    return pos, valid, feats, cam7, i, j, z


@pytest.mark.parametrize("bf16", [False, True])
def test_decode_neighbors_values_and_grads(rng, bf16_mode, bf16):
    """Outputs and grads w.r.t. features, decoder params and the pose
    7-vector of k-NN -> gather -> decode_neighbors, noise injected."""
    bf16_mode(bf16)
    tol = TOL[bf16]
    pos, valid, feats, cam7, i, j, z = _scene(rng)
    T, M, k, cell = 2 ** 10, 32, 8, 0.16
    ropts = jrend.RenderOptions(radius_query=cell, table_size=T,
                                max_per_cell=M)
    topts = port_render_options(ropts)
    fx, fy, cx, cy = 8.0, 8.0, 8.0, 6.0
    n = z.size
    key = jax.random.PRNGKey(11)
    kg, kc = jax.random.split(key)
    noise = [np.asarray(jax.random.normal(kg, (n, 32))),
             np.asarray(jax.random.normal(kc, (n, 32)))]
    wo = rng.normal(size=(n,)).astype(np.float32)
    wc = rng.normal(size=(n, 3)).astype(np.float32)
    params = jax_params(2)
    grid = jknn.build(jnp.asarray(pos), jnp.asarray(valid), cell, T, M)

    def jloss(params, feats, cam7):
        c2w = jcam.c2w_from_tensor(cam7)
        ro, rd = jcam.rays_from_uv(jnp.asarray(i), jnp.asarray(j), c2w,
                                   fx, fy, cx, cy)
        pts = (ro[:, None] + rd[:, None] * jnp.asarray(z)[..., None]
               ).reshape(-1, 3)
        D, I, nn = jknn.query(grid, jnp.asarray(pos),
                              jax.lax.stop_gradient(pts), k, cell, T, M)
        both = jrend.gather_featpos(feats, jnp.asarray(pos), I)
        occ, rgb, has = jrend.decode_neighbors(params, pts, key, ropts,
                                               "color", D, both, nn, cell)
        return jnp.sum(occ * wo) + jnp.sum(rgb * wc), (occ, rgb, has)

    (jl, (jocc, jrgb, jhas)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(feats),
                                                jnp.asarray(cam7))

    dec = decoders_from_numpy(to_np(params), "cpu", bf16_trunks=bf16)
    tgrid = tknn.build(t(pos), t(valid), cell, T, M)
    tf = t(feats).requires_grad_(True)
    tc = t(cam7).requires_grad_(True)
    c2w = tcam.c2w_from_tensor(tc)
    ro, rd = tcam.rays_from_uv(t(i), t(j), c2w, fx, fy, cx, cy)
    pts = (ro[:, None] + rd[:, None] * t(z)[..., None]).reshape(-1, 3)
    D, I, nn = tknn.query(tgrid, t(pos), pts.detach(), k, cell)
    both = trend.gather_featpos(tf, t(pos), I)
    occ, rgb, has = trend.decode_neighbors(
        dec, pts, ReplayDraws(noise, "cpu"), topts, "color", D, both, nn, cell)
    loss = torch.sum(occ * t(wo)) + torch.sum(rgb * t(wc))
    params_t = dict(dec.named_parameters())
    names = list(params_t)
    grads = torch.autograd.grad(loss, [params_t[n] for n in names]
                                + [tf, tc], allow_unused=True)

    assert np.array_equal(has.numpy(), np.asarray(jhas))
    assert has.numpy().mean() > 0.5 and not has.numpy().all()
    assert_close_scaled(occ.detach(), jocc, tol["rtol"], tol["atol"])
    assert_close_scaled(rgb.detach(), jrgb, tol["rtol"], tol["atol"])
    if bf16:
        bf16_mode(False)
        _, (jocc32, jrgb32, _) = jloss(params, jnp.asarray(feats),
                                       jnp.asarray(cam7))
        assert_bf16_emulated(occ.detach(), jocc, jocc32)
        assert_bf16_emulated(rgb.detach(), jrgb, jrgb32)
    gr = tol["grad_rtol"]
    jparam_g = dict(leaves_with_names(to_np(jg[0])))
    for name, g in zip(names, grads[:-2]):
        ref = jparam_g[name]
        if g is None:
            assert not np.any(ref), name
        else:
            assert_close_scaled(g, ref, gr, gr)
    assert_close_scaled(grads[-2], jg[1], gr, gr)      # features
    assert_close_scaled(grads[-1], jg[2], gr, gr)      # pose 7-vector


def test_render_batch_ray_matches(rng):
    """The uncached render path (k-NN inside) with f32 trunks."""
    jdec.set_bf16_trunks(False)
    try:
        pos, valid, feats, cam7, i, j, z = _scene(rng, n_rays=40)
        T, M, cell = 2 ** 10, 32, 0.16
        ropts = jrend.RenderOptions(radius_query=cell, table_size=T,
                                    max_per_cell=M)
        params = jax_params(3)
        c2w = np.asarray(jcam.c2w_from_tensor(jnp.asarray(cam7)))
        ro, rd = jcam.rays_from_uv(jnp.asarray(i), jnp.asarray(j),
                                   jnp.asarray(c2w), 8.0, 8.0, 8.0, 6.0)
        gt_d = np.asarray(z[:, 2]) * (rng.uniform(size=40) > 0.1)
        gt_d = gt_d.astype(np.float32)
        key = jax.random.PRNGKey(5)
        _, kr = jax.random.split(key)
        kg, kc = jax.random.split(key)
        n = 40 * 5
        noise = [np.asarray(jax.random.normal(kg, (n, 32))),
                 np.asarray(jax.random.normal(kc, (n, 32)))]
        grid = jknn.build(jnp.asarray(pos), jnp.asarray(valid), cell, T, M)
        jout = jrend.render_batch_ray(
            params, jnp.asarray(pos), grid, jnp.asarray(feats), ro, rd,
            jnp.asarray(gt_d), jnp.asarray(gt_d > 0), key, ropts, "color")
        dec = decoders_from_numpy(to_np(params), "cpu", bf16_trunks=False)
        tout = trend.render_batch_ray(
            dec, t(pos), tknn.build(t(pos), t(valid), cell, T, M), t(feats),
            t(ro), t(rd), t(gt_d), t(gt_d > 0), ReplayDraws(noise, "cpu"),
            port_render_options(ropts), "color")
        for a, b in zip(tout, jout):
            assert_close_scaled(a.detach(), b, 1e-4, 1e-6)
    finally:
        jdec.set_bf16_trunks(True)
