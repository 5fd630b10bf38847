"""Neural-point decoders: Fourier embedders + geometry/color MLPs.

Port of loopy_slam_tpu/models/decoder.py. The decoders are nn.Modules whose
parameters keep the JAX pytree's names and its (in, out) weight layout
(`geo.lin[0].w` is (93, 32)), so `pretrained/geo_decoder.pkl` and JAX
parameter trees load unchanged (convert.py).

  geometry MLP: Gaussian-Fourier embed p (learnable B: 3x93, sin only) ->
    5 Dense(...->32) with ReLU, per-block feature injection h += fc_c_i(c),
    skip concat of the embedding after block 2, scalar occupancy head.
  color MLP: Fourier embed (fixed B: 3x20, sin||cos -> 40), 5 Dense(->128)
    with softplus(beta=100), feature injection, skip at 2, 3-channel head.
  neighbor transform (color): [fourier(rel_pos; 3x10, sin||cos) || feat]
    -> Dense 52->128 -> softplus100 -> Dense 128->32.

bf16 trunks (on by default, as in the reference): the trunk matmuls round
their INPUTS to bf16 and accumulate in f32, returning the f32 sum unrounded.
A torch bf16 matmul would round its output to bf16, so the port emulates
the reference form with f32 matmuls of bf16-rounded operands (products of
bf16 values are exact in f32).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from .. import resolve_device

GEO_HIDDEN = 32
COL_HIDDEN = 128
N_BLOCKS = 5
SKIP = 2
GEO_EMB = 93
COL_EMB = 20
REL_EMB = 10


class Dense(nn.Module):
    """y = x @ w + b with w stored (in, out) like the JAX pytree."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class _Params(nn.Module):
    """A named group of loose parameters (the pytree's dict leaves)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for k, v in tensors.items():
            setattr(self, k, nn.Parameter(v))


def _module_from_tree(tree) -> nn.Module:
    """Dict/list pytree of tensors -> nested modules with the same names."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([_module_from_tree(t) for t in tree])
    if set(tree) == {"w", "b"}:
        return Dense(tree["w"], tree["b"])
    m = _Params(**{k: v for k, v in tree.items()
                   if isinstance(v, torch.Tensor)})
    for k, v in tree.items():
        if not isinstance(v, torch.Tensor):
            m.add_module(k, _module_from_tree(v))
    return m


class Decoders(nn.Module):
    """{"geo": ..., "col": ...} decoder parameters as modules, plus the
    bf16-trunk switch (a per-object setting, see set_bf16_trunks)."""

    def __init__(self, tree: Dict[str, Any], bf16_trunks: bool = True):
        super().__init__()
        self.geo = _module_from_tree(tree["geo"])
        self.col = _module_from_tree(tree["col"])
        set_bf16_trunks(self, bf16_trunks)

    def tree(self) -> Dict[str, Any]:
        """The parameters as the JAX pytree (tensors, not copies)."""
        return {"geo": _tree_of(self.geo), "col": _tree_of(self.col)}


def _tree_of(m: nn.Module):
    if isinstance(m, nn.ModuleList):
        return [_tree_of(c) for c in m]
    out = {k: p for k, p in m.named_parameters(recurse=False)}
    for k, c in m.named_children():
        out[k] = _tree_of(c)
    return out


def set_bf16_trunks(dec: Decoders, enabled: bool):
    """Select bf16-input/f32-accumulate trunk matmuls for `dec` (the
    reference's process-wide switch, held per decoder object here)."""
    dec.geo.bf16 = bool(enabled)
    dec.col.bf16 = bool(enabled)


def _mm(x, w, bf16: bool):
    """x @ w, optionally with bf16-rounded operands and an f32 sum."""
    if not bf16:
        return x @ w
    return x.bfloat16().float() @ w.bfloat16().float()


def init_decoders(gen: torch.Generator, cfg: Dict[str, Any],
                  device=None) -> Decoders:
    """Randomly initialized decoders with the reference's shapes and init
    distributions (xavier-uniform trunks, torch-Linear fc_c, N(0, s^2)
    embedders), drawn from `gen` (a generator on `device`: the card unless
    the caller asks for the CPU)."""
    dev = resolve_device(device)

    def uni(shape, bound):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    def xavier(shape, gain=1.0):
        return uni(shape, gain * math.sqrt(6.0 / (shape[0] + shape[1])))

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def trunk(in_dim, hidden, skip_extra):
        layers, d = [], in_dim
        for i in range(N_BLOCKS):
            layers.append({"w": xavier((d, hidden), math.sqrt(2.0)),
                           "b": torch.zeros(hidden, device=dev)})
            d = hidden + (skip_extra if i == SKIP else 0)
        return layers

    def fc_c(c_dim, hidden):
        bound = 1.0 / math.sqrt(c_dim)
        return [{"w": uni((c_dim, hidden), bound), "b": uni((hidden,), bound)}
                for _ in range(N_BLOCKS)]

    c_dim = cfg["model"]["c_dim"]
    geo = {
        "B": normal((3, GEO_EMB), 25.0),
        "lin": trunk(GEO_EMB, GEO_HIDDEN, GEO_EMB),
        "fc_c": fc_c(c_dim, GEO_HIDDEN),
        "out": {"w": xavier((GEO_HIDDEN, 1), math.sqrt(2.0)),
                "b": torch.zeros(1, device=dev)},
        "B_rel": normal((3, REL_EMB), 32.0),
    }
    col_emb_in = 2 * COL_EMB
    if cfg["use_view_direction"]:
        col_emb_in += 2 * COL_EMB if cfg["model"]["encode_viewd"] else 3
    nin = c_dim + 2 * REL_EMB
    col = {
        "B": normal((3, COL_EMB), 32.0),
        "B_view": normal((3, COL_EMB), 32.0),
        "B_rel": normal((3, REL_EMB), 32.0),
        "lin": trunk(col_emb_in, COL_HIDDEN, col_emb_in),
        "fc_c": fc_c(c_dim, COL_HIDDEN),
        "out": {"w": xavier((COL_HIDDEN, 3)), "b": torch.zeros(3, device=dev)},
        "neigh": {"w1": xavier((nin, COL_HIDDEN)),
                  "b1": uni((COL_HIDDEN,), 1.0 / math.sqrt(nin)),
                  "w2": xavier((COL_HIDDEN, c_dim)),
                  "b2": uni((c_dim,), 1.0 / math.sqrt(COL_HIDDEN))},
        "exposure": {
            "w1": normal((cfg["model"]["exposure_dim"], COL_HIDDEN), 0.01),
            "b1": torch.zeros(COL_HIDDEN, device=dev),
            "w2": normal((COL_HIDDEN, 12), 0.01),
            "b2": torch.zeros(12, device=dev)},
    }
    return Decoders({"geo": geo, "col": col},
                    bf16_trunks=cfg["model"].get("bf16_trunks", True))


def trainable_mask(dec: Decoders, cfg: Dict[str, Any]) -> Dict[str, bool]:
    """{parameter name: trainable} for the mapper. With fix_geo_decoder the
    geometry trunk is frozen but its embedders train; the color decoder
    trains fully except its fixed embedders B and B_view."""
    fix_geo = cfg["mapping"]["fix_geo_decoder"]
    fix_col = cfg["mapping"]["fix_color_decoder"]
    out = {}
    for name, _ in dec.named_parameters():
        part, leaf = name.split(".", 1)
        if part == "geo":
            on = (not fix_geo) or leaf in ("B", "B_rel")
        else:
            on = not fix_col
            if leaf in ("B", "B_view"):
                on = False
            if fix_col and leaf == "B_rel":
                on = True
            if leaf.startswith("exposure.") \
                    and not cfg["model"]["encode_exposure"]:
                on = False
        out[name] = on
    return out


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def fourier_embed(p, B, concat_cos: bool):
    """sin (|| cos) of 2*pi*p@B, as an exact-f32 broadcast multiply-sum
    (the phase reaches hundreds of radians; no matmul precision games)."""
    t = (2.0 * math.pi) * p[..., :, None] * B
    x = (t[..., 0, :] + t[..., 1, :]) + t[..., 2, :]
    return torch.cat([torch.sin(x), torch.cos(x)], -1) if concat_cos \
        else torch.sin(x)


def softplus100(x):
    """torch.nn.Softplus(beta=100) in the reference's logaddexp form
    (F.softplus switches to the identity past a threshold instead)."""
    return torch.logaddexp(x.new_zeros(()), 100.0 * x) / 100.0


def _trunk(layers, fc_c, out, emb, c, act, bf16):
    h = emb
    for i in range(N_BLOCKS):
        h = act(_mm(h, layers[i].w, bf16) + layers[i].b)
        h = h + (_mm(c, fc_c[i].w, bf16) + fc_c[i].b)
        if i == SKIP:
            h = torch.cat([emb, h], dim=-1)
    return _mm(h, out.w, bf16) + out.b


def geo_forward(geo, p, c):
    """(N,3),(N,32) -> occupancy logits (N,). ReLU trunk."""
    emb = fourier_embed(p, geo.B, concat_cos=False)
    return _trunk(geo.lin, geo.fc_c, geo.out, emb, c, torch.relu,
                  geo.bf16)[..., 0]


def col_forward(col, p, c, views_d=None, use_view_direction=False,
                encode_viewd=True):
    """(N,3),(N,32) -> raw rgb (N,3) before sigmoid. Softplus(100) trunk."""
    emb = fourier_embed(p, col.B, concat_cos=True)
    if use_view_direction:
        v = views_d / (torch.linalg.norm(views_d, dim=-1, keepdim=True)
                       + 1e-12)
        vemb = fourier_embed(v, col.B_view, True) if encode_viewd else v
        emb = torch.cat([emb, vemb], dim=-1)
    return _trunk(col.lin, col.fc_c, col.out, emb, c, softplus100, col.bf16)


def neighbor_transform(col, feats, rel_pos):
    """Rel-pos-conditioned neighbor features (N,k,32)."""
    emb = fourier_embed(rel_pos, col.B_rel, concat_cos=True)  # (N,k,20)
    x = torch.cat([emb, feats], dim=-1)
    h = softplus100(_mm(x, col.neigh.w1, col.bf16) + col.neigh.b1)
    return _mm(h, col.neigh.w2, col.bf16) + col.neigh.b2


def interp_weights(D, r2_bound, weighting="distance"):
    """Inverse-distance (or exponential) interpolation weights (N,k),
    hard-masked outside the radius with no gradient through the mask."""
    if weighting == "distance":
        w = 1.0 / (D + 1e-10)
    else:
        w = torch.exp(-20.0 * torch.sqrt(torch.clamp(D, min=1e-12)))
    mask = (D <= r2_bound).to(w.dtype).detach()
    w = w * mask
    return w / (torch.sum(torch.abs(w), dim=-1, keepdim=True) + 1e-12)


def interpolate_features(feats, weights, has_neighbors, noise):
    """Weighted neighbor sum; positions with too few neighbors get
    0.01 * noise instead (noise: standard-normal draws of the output's
    shape, a draw input)."""
    c = torch.sum(weights[..., None] * feats, dim=-2)
    return torch.where(has_neighbors[..., None], c, 0.01 * noise)
