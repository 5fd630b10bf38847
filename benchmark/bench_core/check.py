"""The comparison that decides `correct`: what the window's timed path
produced against the plain reference in `benchmark/reference/`.

The benchmark captures, from the seed, a few iterations of the window:
two tracking iterations (one in each of the window's first two tracked
frames) and one iteration of its first mapped frame, each with the k-NN
call whose pool it drew from and the Adam step that followed it. For each
it compares:

  knn_gap         the program's neighbour sets against a brute-force search
                  of the whole map: the sorted exact squared distances of
                  the two sets, a missing neighbour taken at the radius,
                  the largest gap as a share of the squared radius;
  track_loss_gap  the tracking loss, |program - reference| / |reference|;
  track_grad_gap  the pose gradient as Adam received it,
                  |g_program - g_reference| / |g_reference|;
  map_loss_gap    the mapping loss, as for tracking;
  map_grad_gap    the gradients of the trained decoder parameters and of
                  the features (the frustum-masked rows), by the worst
                  leaf: |g_p - g_r| over the larger of |g_r| and the median
                  leaf's |g_r|; leaves whose |g_r| lies under a thousandth
                  of the median leaf's are left out (nought to rounding);
  adam_gap        the parameters after the step against the reference's
                  Adam step from the same state and the program's
                  gradients, by the worst leaf, as a share of the step;
  chain_gap       the inputs of the iteration after each captured one (the
                  pose; the decoder parameters and the features) against
                  what the captured Adam step returned, by the worst leaf,
                  as a share of the step: a step whose result the program
                  drops reads 1;
  depth_gap       the depth the loaders handed the tracker at the captured
                  pixels against the depth the benchmark wrote for that
                  frame (`reference/frames.py`), the largest gap in mm;
  color_gap       the colour likewise, the mean gap in levels of 255.

Each number is the largest over the run's captures. With `control`, the
reference computed in bfloat16 (coordinates, features, parameters and
every operation; the k-NN on bfloat16 coordinates) stands in the
program's place beside it, and its numbers come back as "control"; for
the frames the control is the frame before, and for chain_gap a step
whose result is dropped.
"""

from __future__ import annotations

import hashlib
import os
import sys
from typing import Dict, List

import torch

_REF = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reference")
if _REF not in sys.path:
    sys.path.insert(0, os.path.dirname(_REF))

from reference import frames as ref_frames  # noqa: E402
from reference import knn as ref_knn  # noqa: E402
from reference import render as ref  # noqa: E402

NUMBERS = ("knn_gap", "track_loss_gap", "track_grad_gap", "map_loss_gap",
           "map_grad_gap", "adam_gap", "chain_gap", "depth_gap",
           "color_gap")
LOW = torch.bfloat16


class ForbiddenImport(RuntimeError):
    def __init__(self, found: List[str]):
        super().__init__("loaded after the window: " + ", ".join(found))
        self.found = found


def verify_assets(config: Dict, repo_dir: str) -> None:
    """The files the configuration loads are the ones it was frozen with."""
    for rel, digest in config.get("assets_sha256", {}).items():
        with open(os.path.join(repo_dir, rel), "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != digest:
            raise RuntimeError(f"{rel} has sha256 {got}, the configuration "
                               f"was frozen with {digest}")


def _rel(a, b) -> float:
    nb = float(torch.linalg.vector_norm(b.double()))
    return float(torch.linalg.vector_norm((a - b).double())) / max(nb, 1e-30)


def _worst_leaf(progs: List, refs: List, old=None) -> float:
    """The worst leaf's |p - r| over the larger of its own |r - old| and
    the median leaf's; leaves under a thousandth of the median are out."""
    sizes = []
    for r, o in zip(refs, old or [None] * len(refs)):
        d = r.double() if o is None else r.double() - o.double()
        sizes.append(float(torch.linalg.vector_norm(d)))
    med = sorted(sizes)[len(sizes) // 2]
    worst = 0.0
    for p, r, s in zip(progs, refs, sizes):
        if s < 1e-3 * med:
            continue
        gap = float(torch.linalg.vector_norm(p.double() - r.double()))
        worst = max(worst, gap / max(s, med, 1e-30))
    return worst


def _knn(rec, dt):
    pos = rec["pos"][:int(rec["count"])]
    rad = rec["radius"]
    r2 = (rad.double() ** 2 if isinstance(rad, torch.Tensor)
          else torch.tensor(float(rad) ** 2, dtype=torch.float64,
                            device=pos.device))
    k = rec["I"].shape[1]
    q = rec["queries"]
    truth = ref_knn.nearest(pos, q, k, r2)
    slot = torch.arange(k, device=q.device)[None, :]
    prog = torch.where(slot < rec["nn"][:, None].long(), rec["I"].long(),
                       torch.full_like(rec["I"].long(), -1))
    out = float(ref_knn.set_gap(pos, q, prog, truth, r2).max())
    ctrl = None
    if dt is not None:
        low = ref_knn.nearest(pos.to(dt), q.to(dt), k, r2, dt=dt)
        ctrl = float(ref_knn.set_gap(pos, q, low, truth, r2).max())
    return out, ctrl


def _track(rec, dt):
    L_r, g_r = ref.track_loss(rec)
    g_p = rec["adam"]["grads"][0]
    out = (abs(float(rec["loss"]) - float(L_r)) / max(abs(float(L_r)), 1e-30),
           _rel(g_p, g_r))
    ctrl = None
    if dt is not None:
        L_c, g_c = ref.track_loss(rec, dt)
        ctrl = (abs(float(L_c) - float(L_r)) / max(abs(float(L_r)), 1e-30),
                _rel(g_c.float(), g_r))
    return out, ctrl


def _map_grads(rec, g_dec, g_feat):
    names = list(rec["params"])
    fm = rec["feat_mask"][:, None].to(g_feat.dtype)
    return [g_dec[n] for n in names if rec["dec_on"][n]] + [g_feat * fm]


def _map(rec, dt):
    L_r, gd_r, gf_r = ref.map_loss(rec)
    names = list(rec["params"])
    grads = rec["adam"]["grads"]
    prog = [grads[i] if grads[i] is not None else torch.zeros_like(gd_r[n])
            for i, n in enumerate(names) if rec["dec_on"][n]]
    prog.append(grads[len(names)])
    refs = _map_grads(rec, gd_r, gf_r)
    out = (abs(float(rec["loss"]) - float(L_r)) / max(abs(float(L_r)), 1e-30),
           _worst_leaf(prog, refs))
    ctrl = None
    if dt is not None:
        L_c, gd_c, gf_c = ref.map_loss(rec, dt)
        low = [g.float() for g in _map_grads(rec, gd_c, gf_c)]
        ctrl = (abs(float(L_c) - float(L_r)) / max(abs(float(L_r)), 1e-30),
                _worst_leaf(low, refs))
    return out, ctrl


def _adam(rec, dt):
    a = rec["adam"]
    args = (a["params"], a["grads"], a["m"], a["v"], a["step"], a["start"],
            a["lrs"])
    new_r = ref.adam_step(*args)
    out = _worst_leaf(a["new"], new_r, a["params"])
    ctrl = None
    if dt is not None:
        low = [x.float() for x in ref.adam_step(*args, dt=dt)]
        ctrl = _worst_leaf(low, new_r, a["params"])
    return out, ctrl


def _chain(rec, dt):
    """The next iteration's inputs against the step's outputs; a missing
    next iteration, or one of another kind or shape, reads infinite."""
    a, ch = rec["adam"], rec.get("chain")
    n = len(a["new"])
    if (ch is None or ch["kind"] != rec["kind"] or len(ch["inputs"]) != n
            or any(x.shape != y.shape for x, y in zip(ch["inputs"],
                                                      a["new"]))):
        return float("inf"), (1.0 if dt is not None else None)
    out = _worst_leaf(ch["inputs"], a["new"], a["params"])
    ctrl = (_worst_leaf(a["params"], a["new"], a["params"])
            if dt is not None else None)
    return out, ctrl


def _frame(rec, frames, dt):
    """(depth_gap, color_gap) of a tracking capture's pixels."""
    i = rec["i"].long().cpu().numpy()
    j = rec["j"].long().cpu().numpy()
    d = rec["d"].double().cpu().numpy()
    c = rec["c"].double().cpu().numpy() * 255.0
    idx = rec["idx"]

    def gaps(shift):
        return (1e3 * float(abs(d - frames.depth(idx, i, j, shift)).max()),
                float(abs(c - frames.color(idx, i, j, shift)).mean()))
    return gaps(0), (gaps(1) if dt is not None else (None, None))


def compare(records: List[Dict], limits: Dict[str, float], frames,
            control: bool = False) -> Dict[str, Dict]:
    """{number: {"value", "limit", "ok"[, "control"]}}. frames: the
    reference's `frames.Recording` of the run's sequence. A number the run
    has no reading of is not ok."""
    dt = LOW if control else None
    vals: Dict[str, List[float]] = {n: [] for n in NUMBERS}
    ctrls: Dict[str, List[float]] = {n: [] for n in NUMBERS}
    for rec in records:
        if "adam" not in rec:
            continue
        v, cv = _knn(rec, dt)
        vals["knn_gap"].append(v)
        ctrls["knn_gap"].append(cv)
        if rec["kind"] == "track":
            (lv, gv), cv = _track(rec, dt)
            names = ("track_loss_gap", "track_grad_gap")
        else:
            (lv, gv), cv = _map(rec, dt)
            names = ("map_loss_gap", "map_grad_gap")
        for n, x, cx in zip(names, (lv, gv), cv or (None, None)):
            vals[n].append(x)
            ctrls[n].append(cx)
        v, cv = _adam(rec, dt)
        vals["adam_gap"].append(v)
        ctrls["adam_gap"].append(cv)
        v, cv = _chain(rec, dt)
        vals["chain_gap"].append(v)
        ctrls["chain_gap"].append(cv)
        if rec["kind"] == "track":
            for n, x, cx in zip(("depth_gap", "color_gap"),
                                *_frame(rec, frames, dt)):
                vals[n].append(x)
                ctrls[n].append(cx)
    out = {}
    for n in NUMBERS:
        value = max(vals[n]) if vals[n] else None
        limit = float(limits[n])
        ok = value is not None and value == value and value <= limit
        out[n] = {"value": value, "limit": limit, "ok": ok}
        if control:
            cs = [x for x in ctrls[n] if x is not None]
            out[n]["control"] = max(cs) if cs else None
    return out
