"""Parity of the port's ops (camera, masked reductions, sampling,
compositing, Adam, config) with the JAX package, on the CPU.

Tolerance: 1e-6 relative (plus a 1e-7 absolute floor for values near
zero). Both sides compute in float32; they differ only in the order of
the few additions inside a matmul or reduction, and in libm's last bit.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loopy_slam_torch import config as tconfig
from loopy_slam_torch.ops import adam as tadam
from loopy_slam_torch.ops import camera as tcam
from loopy_slam_torch.ops import compositing as tcomp
from loopy_slam_torch.ops import masked as tmasked
from loopy_slam_torch.ops import sampling as tsamp
from loopy_slam_torch.ops.draws import ReplayDraws
from loopy_slam_tpu import config as jconfig
from loopy_slam_tpu.ops import adam as jadam
from loopy_slam_tpu.ops import camera as jcam
from loopy_slam_tpu.ops import compositing as jcomp
from loopy_slam_tpu.ops import masked as jmasked
from loopy_slam_tpu.ops import sampling as jsamp

RTOL, ATOL = 1e-6, 1e-7


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def t(a):
    return torch.as_tensor(np.asarray(a))


def random_poses(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    tr = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    return np.concatenate([q, tr], 1)


def test_config_defaults_and_yamls_equal():
    assert tconfig.DEFAULTS == jconfig.DEFAULTS
    paths = sorted(glob.glob("configs/**/*.yaml", recursive=True))
    assert paths
    for p in paths:
        assert tconfig.load_config(p) == jconfig.load_config(p), p


def test_pose_conversions_values_and_grads(rng):
    t7 = random_poses(rng, 16)
    W = rng.normal(size=(16, 3, 4)).astype(np.float32)
    close(tcam.c2w_from_tensor(t(t7)), jcam.c2w_from_tensor(jnp.asarray(t7)))
    jg = jax.grad(lambda x: jnp.sum(jcam.c2w_from_tensor(x) * W))(
        jnp.asarray(t7))
    x = t(t7).requires_grad_(True)
    torch.sum(tcam.c2w_from_tensor(x) * t(W)).backward()
    close(x.grad, jg, rtol=1e-5, atol=1e-6)
    for p in t7[:4]:
        c2w = jcam.np_c2w_from_tensor(p)
        np.testing.assert_array_equal(tcam.np_c2w_from_tensor(p), c2w)
        np.testing.assert_array_equal(tcam.tensor_from_c2w(c2w),
                                      jcam.tensor_from_c2w(c2w))
        close(tcam.c2w_to_4x4(t(c2w[:3])), jcam.c2w_to_4x4(c2w[:3]))
        close(tcam.invert_c2w(t(c2w)), jcam.invert_c2w(jnp.asarray(c2w)),
              rtol=1e-5, atol=1e-6)


def test_rays_and_projection(rng):
    c2w = jcam.np_c2w_from_tensor(random_poses(rng, 1)[0])
    ro, rd = tcam.get_rays(6, 8, 5.0, 5.5, 3.5, 2.5, t(c2w))
    jro, jrd = jcam.get_rays(6, 8, 5.0, 5.5, 3.5, 2.5, jnp.asarray(c2w))
    close(ro, jro)
    close(rd, jrd, atol=1e-6)
    pts = rng.uniform(-2, 2, size=(50, 3)).astype(np.float32)
    uv, z = tcam.project_points(t(pts), t(c2w), 5.0, 5.5, 3.5, 2.5)
    juv, jz = jcam.project_points(jnp.asarray(pts), jnp.asarray(c2w),
                                  5.0, 5.5, 3.5, 2.5)
    close(z, jz, atol=1e-6)
    close(uv, juv, rtol=1e-5, atol=1e-5)
    a = rng.normal(size=(3, 20))
    b = a + 0.01 * rng.normal(size=(3, 20))
    for x, y in zip(tcam.horn_align(a, b), jcam.horn_align(a, b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n_valid", [0, 1, 6, 7, 40])
def test_masked_reductions(rng, n_valid):
    x = rng.uniform(0.1, 5, size=40).astype(np.float32)
    mask = np.zeros(40, bool)
    mask[rng.permutation(40)[:n_valid]] = True
    for tf, jf in ((tmasked.masked_sum, jmasked.masked_sum),
                   (tmasked.masked_mean, jmasked.masked_mean),
                   (tmasked.masked_max, jmasked.masked_max),
                   (tmasked.masked_median, jmasked.masked_median)):
        close(tf(t(x), t(mask)), jf(jnp.asarray(x), jnp.asarray(mask)))


def test_sampling_with_injected_draws(rng):
    H, W, n = 12, 16, 64
    depth = rng.uniform(0.5, 3, size=(H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.2] = 0
    color = rng.uniform(size=(H, W, 3)).astype(np.float32)
    c2w = jcam.np_c2w_from_tensor(random_poses(rng, 1)[0])
    key = jax.random.PRNGKey(3)
    kh, kw = jax.random.split(key)
    draws = [np.asarray(jax.random.randint(kh, (n,), 2, H - 2)),
             np.asarray(jax.random.randint(kw, (n,), 1, W - 1))]
    jout = jsamp.sample_rays(key, 2, H - 2, 1, W - 1, n, jnp.asarray(c2w),
                             jnp.asarray(depth), jnp.asarray(color),
                             7.0, 7.0, 7.5, 5.5, depth_limit=2.5)
    tout = tsamp.sample_rays(ReplayDraws(draws, "cpu"), 2, H - 2, 1, W - 1, n,
                             t(c2w), t(depth), t(color), 7.0, 7.0, 7.5, 5.5,
                             depth_limit=2.5)
    for a, b in zip(tout, jout):
        close(a, b, atol=1e-6)
    d, valid = tout[2], tout[4]
    close(tsamp.inside_mask_from_depth(d, valid),
          jsamp.inside_mask_from_depth(jout[2], jout[4]))
    z = tsamp.surface_z_vals(d, valid, 5, 0.98, 1.02, 0.3)
    jz = jsamp.surface_z_vals(jout[2], jout[4], 5, 0.98, 1.02, 0.3)
    close(z, jz)
    close(tsamp.pixels_to_points(tout[0], tout[1], z),
          jsamp.pixels_to_points(jout[0], jout[1], jz), atol=1e-6)


def test_composite_values_and_grads(rng):
    R, S = 32, 5
    rgb = rng.uniform(size=(R, S, 3)).astype(np.float32)
    occ = rng.normal(scale=30, size=(R, S)).astype(np.float32)
    occ[:4] = -100.0
    z = np.sort(rng.uniform(0.5, 3, size=(R, S)), 1).astype(np.float32)
    w = rng.normal(size=(4,)).astype(np.float32)

    def jloss(a, b, c):
        dd, dv, col, wt = jcomp.composite(a, b, c, 0.1)
        return (w[0] * jnp.sum(dd) + w[1] * jnp.sum(dv)
                + w[2] * jnp.sum(col) + w[3] * jnp.sum(wt))

    jargs = [jnp.asarray(a) for a in (rgb, occ, z)]
    targs = [t(a).requires_grad_(True) for a in (rgb, occ, z)]
    for a, b in zip(tcomp.composite(*targs, 0.1),
                    jcomp.composite(*jargs, 0.1)):
        close(a.detach(), b, atol=1e-6)
    dd, dv, col, wt = tcomp.composite(*targs, 0.1)
    (w[0] * dd.sum() + w[1] * dv.sum() + w[2] * col.sum()
     + w[3] * wt.sum()).backward()
    for a, b in zip(targs, jax.grad(jloss, argnums=(0, 1, 2))(*jargs)):
        close(a.grad, b, rtol=1e-5, atol=1e-6)


def test_adam_steps_with_zero_and_missing_grads(rng):
    shapes = [(5, 3), (7,), (4, 6)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    lr = [0.01, 0.002, np.linspace(0.001, 0.01, 6).astype(np.float32)]
    jp = [jnp.asarray(p) for p in params]
    jst = jadam.init(jp)
    tp = [t(p) for p in params]
    tst = tadam.init(tp)
    for step in range(4):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        if step >= 2:  # leaf 1: zero grads after two real steps
            grads[1] = np.zeros(shapes[1], np.float32)
        jp, jst = jadam.update(jp, [jnp.asarray(g) for g in grads], jst,
                               [jnp.float32(lr[0]), jnp.float32(lr[1]),
                                jnp.asarray(lr[2])])
        tg = [t(g) for g in grads]
        if step >= 2:
            tg[1] = None  # a missing grad counts as zero, m/v still decay
        tp, tst = tadam.update(tp, tg, tst, [lr[0], lr[1], t(lr[2])])
        for a, b in zip(tp, jp):
            close(a, b)
    assert tst.step == int(jst.step) == 4
