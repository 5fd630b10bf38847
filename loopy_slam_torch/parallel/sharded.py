"""Ray data parallelism on a replicated map (port of
loopy_slam_tpu/parallel/sharded.py over torch.distributed).

Every rank holds the whole map, the decoders and the Adam state; each
samples its own share of the rays (pix_per_frame / n a frame) from its
own draws, and the gradients and loss terms are summed over the ranks
every iteration (mapper._optimize_map_impl's mesh hook), so every rank
applies the same update and the replicated state stays equal. Rays need
no neighbour exchange (each ray's k-NN reads the local copy of the map),
so the only collective is the per-iteration gradient sum. Mapping only:
the session tracks on rank 0 and broadcasts the pose (slam.py).
"""

from __future__ import annotations

import torch

from ..mapping.mapper import _optimize_map_impl
from ..models.renderer import render_batch_ray


def sharded_optimize_map(mesh, dec, feat, adam_state, dec_mask, feat_mask,
                         map_pos, grid, kf_color, kf_depth, kf_c2w, draw,
                         n_geo_iters, n_col_iters, lrs_geo, lrs_col, opts,
                         ropts, pix_per_frame: int, **kw):
    """The staged mapping optimizer (mapper.optimize_map, the same
    arguments) with this rank's pix_per_frame / n rays a frame from its own
    `draw` and the gradients summed over the mesh (the counterpart of
    make_sharded_optimize_map). BA's poses ride the same sum."""
    return _optimize_map_impl(
        dec, feat, adam_state, dec_mask, feat_mask, map_pos, grid, kf_color,
        kf_depth, kf_c2w, draw, n_geo_iters, n_col_iters, lrs_geo, lrs_col,
        opts, ropts, max(pix_per_frame // mesh.size(), 1), mesh=mesh, **kw)


def sharded_train_step(mesh, dec, feat, adam_state, dec_mask, feat_mask,
                       map_pos, grid, kf_color, kf_depth, kf_c2w, draw, lrs,
                       opts, ropts, pix_per_frame: int):
    """One color-stage Adam step over a keyframe window with fresh rays (no
    ray pool), data parallel (the counterpart of make_sharded_train_step).
    Returns (feat, adam_state, loss) with the loss summed over the ranks."""
    feat, adam_state, aux = sharded_optimize_map(
        mesh, dec, feat, adam_state, dec_mask, feat_mask, map_pos, grid,
        kf_color, kf_depth, kf_c2w, draw, 0, 1, lrs, lrs,
        opts._replace(pixel_pool_factor=0), ropts, pix_per_frame)[:3]
    return feat, adam_state, aux[0] + opts.w_color_loss * aux[1]


@torch.no_grad()
def sharded_render(mesh, dec, map_pos, grid, feats, rays_o, rays_d,
                   gt_depth, draw, ropts):
    """render_batch_ray in the color stage with the rays split over the
    ranks (rank r takes the r-th of n contiguous blocks) and the results
    gathered on every rank (the counterpart of make_sharded_render)."""
    R = rays_o.shape[0]
    n, r = mesh.size(), mesh.rank
    lo, hi = R * r // n, R * (r + 1) // n
    d = gt_depth[lo:hi]
    out = render_batch_ray(dec, map_pos, grid, feats, rays_o[lo:hi],
                           rays_d[lo:hi], d, d > 0, draw, ropts, "color")
    depth, var, color, valid = out
    return (*(mesh.all_gather_rows(t) for t in (depth, var, color)),
            mesh.all_gather_rows(valid.to(torch.float32)) > 0.5)
