"""The tracker's render step on its k-NN pool: decode and composite the
pixels' samples, as one autograd Function.

`tracker.tracking_loss_cached` calls `render` once an iteration, in place
of the `decode_neighbors` + `composite` pair, whenever `eligible` holds:
no exposure, no view direction, distance weighting, and the widths the
kernels are written for (c_dim 32, nn_num <= 16, n_surface <= 31). It takes
the sample points (R*S, 3), which carry the pose's gradient, the pool and
the iteration's pick into it, the rays' z-vals (R, S) and the two noise
draws, and returns the rays' depth (R,), depth variance (R,) and colour
(R, 3), as `composite` does.

On CUDA tensors it launches the two kernels of csrc/track_render.cu: the
forward decodes and composites (reading the pool's rows through `pick`,
so nothing is gathered into device memory), the backward carries the
rays' depth and colour gradients back to the sample points. The variance
takes no gradient (the tracking loss detaches it). Neither launch reads a
device value on the host. On CPU tensors it runs `_render_plain`, today's
composition of `decode_neighbors` and `composite`, bit for bit. It never
falls back: a CUDA call the kernels cannot take raises.

The mapper, the uncached tracker and the renders keep `decode_neighbors`
and `composite`: they need gradients for the decoders and the features,
which these kernels do not compute.

Under a cost counter (utils/cost.py) the kernels report the work the plain
route counts for the same shapes, forward and backward apart, so that
`LoopySLAM.roofline()` reads the same on either route.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import knn
from ..ops.compositing import composite
from ..utils import cost
from .decoder import (COL_EMB, COL_HIDDEN, GEO_EMB, GEO_HIDDEN, N_BLOCKS,
                      REL_EMB)
from .renderer import RenderOptions, decode_neighbors

C_DIM = 32  # the kernels' feature width
MAX_K = 16  # the most neighbours a sample
MAX_S = 31  # the most samples a ray (the compositing scans S + 1 in 32)


# launch count of the two kernels: the wrapper adds one per launch
TRACK_RENDER_LAUNCHES = knn._Launches()


def eligible(ropts: RenderOptions, exposure=None) -> bool:
    """Whether the tracker's cached iteration renders through `render`:
    decided on options alone, the device aside."""
    return (exposure is None and not ropts.encode_exposure
            and not ropts.use_view_direction
            and ropts.weighting == "distance"
            and ropts.c_dim == C_DIM and 1 <= ropts.nn_num <= MAX_K
            and 1 <= ropts.n_surface <= MAX_S)


class _Drawn:
    """A draw that hands out the given normal tensors in order (the
    decode's geometry and colour noise, drawn before the call)."""

    def __init__(self, *noises):
        self.noises = list(noises)

    def normal(self, shape):
        t = self.noises.pop(0)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"noise of shape {tuple(t.shape)}, the decode "
                             f"asked for {tuple(shape)}")
        return t


def _render_plain(dec, pts, z, cache, pick, noise_geo, noise_col,
                  ropts: RenderOptions):
    """The plain PyTorch version: the pool rows taken through `pick`, then
    decode_neighbors and composite."""
    S, k = ropts.n_surface, ropts.nn_num
    R = pick.shape[0]

    def take(a):
        return a.index_select(0, pick)

    D_idx = take(cache["D"]).reshape(R * S, k)
    both = take(cache["both"]).reshape(R * S, k, -1)
    nn = take(cache["nn"]).reshape(R * S)
    rq = (ropts.radius_query if cache["rq"] is None
          else torch.repeat_interleave(take(cache["rq"]), S))
    occ, rgb, _has = decode_neighbors(
        dec, pts, _Drawn(noise_geo, noise_col), ropts, "color", D_idx, both,
        nn, rq)
    depth, var, color, _ = composite(
        rgb.reshape(R, S, 3), occ.reshape(R, S), z, ropts.sigmoid_coef)
    return depth, var, color


def _weights(dec):
    """The decoders' parameters in the kernels' order (csrc/track_render.cu
    `W_*`): geometry B, lin (w, b) x 5, fc_c (w, b) x 5, out (w, b); colour
    B, B_rel, lin x 5, fc_c x 5, out, neigh (w1, b1, w2, b2)."""
    g, c = dec.geo, dec.col
    out = [g.B]
    for i in range(N_BLOCKS):
        out += [g.lin[i].w, g.lin[i].b]
    for i in range(N_BLOCKS):
        out += [g.fc_c[i].w, g.fc_c[i].b]
    out += [g.out.w, g.out.b, c.B, c.B_rel]
    for i in range(N_BLOCKS):
        out += [c.lin[i].w, c.lin[i].b]
    for i in range(N_BLOCKS):
        out += [c.fc_c[i].w, c.fc_c[i].b]
    out += [c.out.w, c.out.b, c.neigh.w1, c.neigh.b1, c.neigh.w2,
            c.neigh.b2]
    return out


def _weight_shapes():
    """The shapes the kernels read the parameters at, in _weights' order
    (no view direction: the colour embedding is 2 * COL_EMB wide)."""
    c_emb_in = 2 * COL_EMB
    gin = [GEO_EMB, GEO_HIDDEN, GEO_HIDDEN, GEO_HIDDEN + GEO_EMB, GEO_HIDDEN]
    cin = [c_emb_in, COL_HIDDEN, COL_HIDDEN, COL_HIDDEN + c_emb_in,
           COL_HIDDEN]
    s = [(3, GEO_EMB)]
    for i in range(N_BLOCKS):
        s += [(gin[i], GEO_HIDDEN), (GEO_HIDDEN,)]
    for _ in range(N_BLOCKS):
        s += [(C_DIM, GEO_HIDDEN), (GEO_HIDDEN,)]
    s += [(GEO_HIDDEN, 1), (1,), (3, COL_EMB), (3, REL_EMB)]
    for i in range(N_BLOCKS):
        s += [(cin[i], COL_HIDDEN), (COL_HIDDEN,)]
    for _ in range(N_BLOCKS):
        s += [(C_DIM, COL_HIDDEN), (COL_HIDDEN,)]
    s += [(COL_HIDDEN, 3), (3,), (C_DIM + 2 * REL_EMB, COL_HIDDEN),
          (COL_HIDDEN,), (COL_HIDDEN, C_DIM), (C_DIM,)]
    return s


_SHAPES = _weight_shapes()
_checked: dict = {}  # id(dec) -> the pointer tuple last validated


def _weight_array(dec, dev):
    """A ctypes array of the parameters' device pointers, validated (f32,
    contiguous, on `dev`, at the kernels' shapes) once per set of
    pointers."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ws = _weights(dec)
    ptrs = tuple(w.data_ptr() for w in ws)
    if _checked.get(id(dec)) != ptrs:
        for w, shape in zip(ws, _SHAPES):
            if w.device != dev or w.dtype != torch.float32 \
                    or tuple(w.shape) != shape or not w.is_contiguous():
                raise ValueError(
                    f"track_render takes contiguous float32 decoder "
                    f"parameters on {dev} at {shape}, got {w.dtype} "
                    f"{tuple(w.shape)} on {w.device}")
        _checked[id(dec)] = ptrs
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _check(name, t, dev, dtype, shape):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"track_render: {name} must be a contiguous "
                         f"{dtype} {shape} tensor on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}"
                         + ("" if t.is_contiguous() else " (strided)"))


def rays_per_block(S: int) -> int:
    """Whole rays in a block's 64 sample slots (csrc/track_render.cu)."""
    return 64 // S


_plain_cost: dict = {}  # shape key -> ((fwd), (bwd)) counts


def _cost_of_plain(dec, pts, z, cache, pick, noise_geo, noise_col, ropts):
    """The plain route's count at these shapes, forward and backward to
    the points: ((flops, bytes, transcendentals, products), (...)). Runs
    the plain version once per shape on the call's own inputs under a
    counter of its own (the callers' counters paused); the count depends
    on shapes alone."""
    key = (pts.device.type, pick.shape[0], tuple(cache["both"].shape),
           cache["rq"] is None, ropts, dec.geo.bf16, dec.col.bf16)
    if key not in _plain_cost:
        with cost.uncounted(), torch.enable_grad():
            p = pts.detach().requires_grad_(True)
            with cost.CostCounter() as fc:
                depth, var, color = _render_plain(
                    dec, p, z, cache, pick, noise_geo, noise_col, ropts)
            gd, gc = torch.ones_like(depth), torch.ones_like(color)
            with cost.CostCounter() as bc:
                torch.autograd.grad((depth, color), (p,), (gd, gc))
        _plain_cost[key] = tuple(
            (cc.flops, cc.bytes, cc.transcendentals, cc.products)
            for cc in (fc, bc))
    return _plain_cost[key]


class _TrackRender(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, z, dec, cache, pick, noise_geo, noise_col,
                ropts):
        from ..csrc.build import load_track_library

        dev = pts.device
        S, K, C = ropts.n_surface, ropts.nn_num, ropts.c_dim
        R = pick.shape[0]
        P = cache["d"].shape[0]
        n = R * S
        _check("pts", pts, dev, torch.float32, (n, 3))
        _check("z", z, dev, torch.float32, (R, S))
        _check("pick", pick, dev, torch.int64, (R,))
        _check("pool D", cache["D"], dev, torch.float32, (P, S * K))
        _check("pool rows", cache["both"], dev, torch.float32,
               (P, S * K, 2 * C + 3))
        _check("pool nn", cache["nn"], dev, torch.int32, (P, S))
        _check("geometry noise", noise_geo, dev, torch.float32, (n, C))
        _check("colour noise", noise_col, dev, torch.float32, (n, C))
        rq = cache["rq"]
        if rq is not None:
            _check("pool radii", rq, dev, torch.float32, (P,))
        w = _weight_array(dec, dev)
        rel = bool(ropts.encode_rel_pos_in_col)
        flags = (int(rel), int(dec.geo.bf16), int(dec.col.bf16))
        lib = load_track_library()
        nblk = -(-R // rays_per_block(S))
        depth = torch.empty((R,), dtype=torch.float32, device=dev)
        var = torch.empty((R,), dtype=torch.float32, device=dev)
        color = torch.empty((R, 3), dtype=torch.float32, device=dev)
        # what the backward reads of the forward, per block of rays
        save = torch.empty((nblk * lib.track_render_save_floats(K, rel),),
                           dtype=torch.float32, device=dev)
        rq_ptr = None if rq is None else rq.data_ptr()
        rq_scalar = ctypes.c_float(float(ropts.radius_query))
        coef = ctypes.c_float(float(ropts.sigmoid_coef))
        if R > 0:
            stream = torch.cuda.current_stream(dev).cuda_stream
            with torch.cuda.device(dev):
                rc = lib.track_render_forward(
                    w, pts.data_ptr(), pick.data_ptr(), cache["D"].data_ptr(),
                    cache["both"].data_ptr(), cache["nn"].data_ptr(),
                    z.data_ptr(), rq_ptr, rq_scalar, noise_geo.data_ptr(),
                    noise_col.data_ptr(), depth.data_ptr(), var.data_ptr(),
                    color.data_ptr(), save.data_ptr(), R, S, K,
                    ropts.min_nn_num, *flags, coef, stream)
            if rc != 0:
                raise RuntimeError(f"track_render forward launch failed with "
                                   f"CUDA error {rc} (R={R}, S={S}, K={K})")
            TRACK_RENDER_LAUNCHES.count += 1
        if cost.active():
            fwd, bwd = _cost_of_plain(dec, pts, z, cache, pick, noise_geo,
                                      noise_col, ropts)
            cost.report("track_render", *fwd)
            ctx.bwd_cost = bwd
        else:
            ctx.bwd_cost = None
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(pts, z, pick, save)
        ctx.args = (w, cache, rq_ptr, rq_scalar, coef, R, S, K,
                    ropts.min_nn_num, flags)
        ctx.mark_non_differentiable(var)
        return depth, var, color

    @staticmethod
    def backward(ctx, g_depth, _g_var, g_color):
        from ..csrc.build import load_track_library

        pts, z, pick, save = ctx.saved_tensors
        w, cache, rq_ptr, rq_scalar, coef, R, S, K, min_nn, flags = ctx.args
        dev = pts.device
        gpts = torch.empty_like(pts)
        gd_ptr = gc_ptr = None
        gd_s = gc_s0 = gc_s1 = 0
        if g_depth is not None:
            gd_ptr, gd_s = g_depth.data_ptr(), g_depth.stride(0)
        if g_color is not None:
            gc_ptr = g_color.data_ptr()
            gc_s0, gc_s1 = g_color.stride()
        if R > 0:
            lib = load_track_library()
            stream = torch.cuda.current_stream(dev).cuda_stream
            with torch.cuda.device(dev):
                rc = lib.track_render_backward(
                    w, pts.data_ptr(), pick.data_ptr(), cache["D"].data_ptr(),
                    cache["both"].data_ptr(), cache["nn"].data_ptr(),
                    z.data_ptr(), rq_ptr, rq_scalar, gd_ptr, gd_s, gc_ptr,
                    gc_s0, gc_s1, save.data_ptr(), gpts.data_ptr(), R, S, K,
                    min_nn, *flags, coef, stream)
            if rc != 0:
                raise RuntimeError(f"track_render backward launch failed "
                                   f"with CUDA error {rc} (R={R}, S={S}, "
                                   f"K={K})")
            TRACK_RENDER_LAUNCHES.count += 1
        if ctx.bwd_cost is not None:
            cost.report("track_render_bwd", *ctx.bwd_cost)
        return (gpts,) + (None,) * 7


def render(dec, pts, z, cache, pick, noise_geo, noise_col,
           ropts: RenderOptions):
    """Depth (R,), depth variance (R,) and colour (R, 3) of the rays whose
    pool rows `pick` (R,) names, at the sample points pts (R*S, 3) with
    z-vals z (R, S); noise_geo / noise_col (R*S, c_dim): the decode's
    draws. `cache` is the tracker's pool (`_build_track_cache`). Only for
    options that `eligible` accepts."""
    if pts.device.type == "cpu":
        return _render_plain(dec, pts, z, cache, pick, noise_geo, noise_col,
                             ropts)
    return _TrackRender.apply(pts, z, dec, cache, pick, noise_geo,
                              noise_col, ropts)
