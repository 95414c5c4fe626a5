"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference under ``reference/``, number by number, each
against the limit its cell's file states.

Serving is judged on a sample of the window's frames drawn from the
seed (:func:`serve_numbers`), against the reference's crop, network,
decode and solve of the same frame, box and RANSAC uniforms:

* ``heatmap_gap``: the widest gap between the served heatmaps and the
  reference's (crop and network);
* ``keypoint_gap_px``: the widest gap between the served full-frame
  keypoints and the reference's decode of the served heatmaps (the
  decode and the uncrop, on the same heatmaps);
* ``confidence_gap``: the widest gap between the served confidences and
  the reference's own (the heatmaps' maxima);
* ``rotation_gap_p99_rad``, ``translation_gap_p99``: the 99th percentile
  over the frames of the served pose's gap to the reference's own pose
  (selection, RANSAC-EPnP, dual LM; the translation relative).  The
  widest gap is not compared: bf16 rounding alone can tip a discrete
  choice (a confidence across the 0.6 threshold, a hypothesis, the mirror
  pose) in a frame or two.

Training is judged twice by :func:`train_numbers`: on the program's
first call (its first ``n_inner`` steps from the weights), against the
reference from the same weights; and on one call of the window, drawn
from the seed, against the reference from the program's state just
before that call (the state, Adam's moments and step and the running
statistics, copied before and after it), on the same batches; that
call's numbers are named ``window_...``.  Each compares the worst step's loss, and per leaf
the norm of the root mean square of the gradients as Adam got them over
the call (from its second moment before and after), of the parameters'
change and of the running statistics' change: each leaf's gap between
the two norms over the reference's norm of that leaf or of the median
leaf, whichever is larger; the median leaf's gap and the 90th
percentile leaf's (``..._p90``, for a fault confined to a few leaves).

:func:`judge` compares the numbers the cell's file gives limits for; a
limit whose number is missing fails.
"""

from __future__ import annotations

import math

import torch

from h100_bench.reference import serve as ref_serve

BETA2 = 0.999


def _gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| elementwise in f64; where either is not finite, infinite
    unless both are equal (both NaN counts as agreement)."""
    a, b = a.double(), b.double()
    d = (a - b).abs()
    both_nan = torch.isnan(a) & torch.isnan(b)
    same_inf = torch.isinf(a) & (a == b)
    bad = ~torch.isfinite(d) & ~(both_nan | same_inf)
    d = torch.where(both_nan | same_inf, 0.0, d)
    return torch.where(bad, math.inf, d)


def _angle(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """The angle of ``Ra^T Rb``, from ``|Ra - Rb|_F = 2 sqrt(2) sin(a / 2)``
    (exact to rounding at small angles, where the trace's arccos is not)."""
    f = (Ra.double() - Rb.double()).flatten(-2).norm(dim=-1)
    ang = 2.0 * torch.arcsin(torch.clamp(f / (2.0 * math.sqrt(2.0)), max=1.0))
    return torch.where(torch.isfinite(ang), ang, math.inf)


def serve_numbers(ref_model, frames: torch.Tensor, boxes: torch.Tensor,
                  uniforms: torch.Tensor, out: dict, pts: torch.Tensor,
                  cfg: dict, block: int = 64,
                  detail: bool = False) -> dict[str, float]:
    """The served outputs ``out`` (heatmaps, keypoints_2d, confidences, R,
    trans; a row per frame of ``frames``) judged against the reference,
    in blocks of ``block`` frames.  ``detail`` adds readings that are not
    compared (the solve on the served keypoints, the widest pose gaps,
    quantiles)."""
    serving = cfg['serving']
    rows: dict[str, list] = {}

    def add(key, value):
        rows.setdefault(key, []).append(value.reshape(value.shape[0], -1)
                                        .amax(-1).cpu())

    for s in range(0, frames.shape[0], block):
        sl = slice(s, s + block)
        hm = out['heatmaps'][sl].to(torch.float32)
        hm_ref, rates, origins = ref_serve.heatmaps(
            ref_model, frames[sl], boxes[sl], cfg['crop_size'])
        add('heatmap_gap', _gap(hm, hm_ref))
        kp_ref, _ = ref_serve.decode(hm, rates, origins)
        add('keypoint_gap_px', _gap(out['keypoints_2d'][sl], kp_ref))
        # the reference's own decode and solve of its own heatmaps
        kp_own, conf_own = ref_serve.decode(hm_ref, rates, origins)
        add('confidence_gap', _gap(out['confidences'][sl], conf_own))
        R_own, t_own = ref_serve.solve(pts, kp_own, conf_own, hm_ref, rates,
                                       origins, uniforms[sl], serving)
        add('rotation_gap_rad', _angle(out['R'][sl], R_own))
        add('translation_gap', _rel(out['trans'][sl], t_own))
        if detail:
            R_tf, t_tf = ref_serve.solve(
                pts, out['keypoints_2d'][sl], out['confidences'][sl], hm, rates,
                origins, uniforms[sl], serving)
            add('solve_rotation_gap_rad', _angle(out['R'][sl], R_tf))
            add('solve_translation_gap', _rel(out['trans'][sl], t_tf))
    rows = {k: torch.cat(v).double() for k, v in rows.items()}
    res = {'heatmap_gap': float(rows['heatmap_gap'].max()),
           'keypoint_gap_px': float(rows['keypoint_gap_px'].max()),
           'confidence_gap': float(rows['confidence_gap'].max()),
           'rotation_gap_p99_rad': _p99(rows['rotation_gap_rad']),
           'translation_gap_p99': _p99(rows['translation_gap'])}
    if detail:
        for k, v in rows.items():
            res[k + '.max'] = float(v.max())
            res[k + '.p99'] = _p99(v)
            res[k + '.median'] = float(v.median())
    return res


def _p99(v: torch.Tensor) -> float:
    """The 99th percentile over the frames (linear between ranks); a
    frame that is not finite counts as infinite."""
    v = torch.nan_to_num(v, nan=math.inf)
    return float(torch.quantile(v.clamp(max=1e300), 0.99))


def _rel(t: torch.Tensor, t_ref: torch.Tensor) -> torch.Tensor:
    g = _gap(t, t_ref).norm(dim=-1) / t_ref.double().norm(dim=-1)
    return torch.nan_to_num(g, nan=math.inf)


def control_outputs(ref_model, frames: torch.Tensor, boxes: torch.Tensor,
                    uniforms: torch.Tensor, pts: torch.Tensor, cfg: dict,
                    block: int = 64) -> dict[str, torch.Tensor]:
    """The reference in the program's place, one precision below the
    configuration's (fp8 network, bf16 decode, TF32 solver)."""
    parts: dict[str, list] = {k: [] for k in
                              ('heatmaps', 'keypoints_2d', 'confidences',
                               'R', 'trans')}
    for s in range(0, frames.shape[0], block):
        sl = slice(s, s + block)
        hm, rates, origins = ref_serve.heatmaps(
            ref_model, frames[sl], boxes[sl], cfg['crop_size'], low=True)
        kp, conf = ref_serve.decode(hm, rates, origins, low=True)
        R, t = ref_serve.solve(pts, kp, conf, hm, rates, origins,
                               uniforms[sl], cfg['serving'], low=True)
        for k, v in zip(parts, (hm, kp, conf, R, t)):
            parts[k].append(v)
    return {k: torch.cat(v) for k, v in parts.items()}


# ---------------------------------------------------------------------------
# training

def leaf_norms(named_params: dict[str, torch.Tensor],
               start: dict[str, torch.Tensor],
               second_moment: dict[str, torch.Tensor], steps: int,
               named_stats: dict[str, torch.Tensor],
               start_stats: dict[str, torch.Tensor],
               moment_before: dict[str, torch.Tensor] | None = None
               ) -> dict[str, dict]:
    """Per leaf: ``grad`` the norm of the root mean square of the leaf's
    gradients over the ``steps`` steps, elementwise, from Adam's second
    moment after them and ``moment_before`` them (zero where None),
    ``update`` the norm of the parameter's change since ``start``; per
    running statistic ``stat`` its change's norm."""
    decay = BETA2 ** steps
    out: dict[str, dict] = {'grad': {}, 'update': {}, 'stat': {}}
    for name, p in named_params.items():
        out['update'][name] = float((p.double() - start[name].double())
                                    .norm())
        v = second_moment[name].double()
        if moment_before is not None:
            v = (v - decay * moment_before[name].double()).clamp(min=0.0)
        out['grad'][name] = float((v / (1.0 - decay)).sqrt().norm())
    for name, s in named_stats.items():
        out['stat'][name] = float((s.double() - start_stats[name].double())
                                  .norm())
    return out


def _leaf_gaps(prog: dict[str, float], ref: dict[str, float],
               leaves) -> list[float]:
    """Each leaf's gap of norms over the reference's norm of that leaf or
    of the median leaf, whichever is larger; sorted."""
    med = sorted(ref[k] for k in leaves)[len(leaves) // 2]
    return sorted(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                  for k in leaves)


def _worst_leaf(prog, ref, leaves) -> float:
    return _leaf_gaps(prog, ref, leaves)[-1]


def _median_leaf(prog, ref, leaves) -> float:
    gaps = _leaf_gaps(prog, ref, leaves)
    return gaps[len(gaps) // 2]


def _p90_leaf(prog, ref, leaves) -> float:
    """The 90th percentile leaf's gap (nearest rank)."""
    gaps = _leaf_gaps(prog, ref, leaves)
    return gaps[max(math.ceil(0.9 * len(gaps)) - 1, 0)]


def moved_leaves(ref_norms: dict) -> list[str]:
    """The leaves counted in ``update_gap``: those whose gradient in the
    reference is above a thousandth of the median leaf's (the others move
    under Adam by round-off alone)."""
    grads = ref_norms['grad']
    med = sorted(grads.values())[len(grads) // 2]
    return [k for k, g in grads.items() if g > 1e-3 * med]


def train_numbers(prog_losses: torch.Tensor, prog_norms: dict,
                  ref_losses: torch.Tensor, ref_norms: dict,
                  detail: bool = False, prefix: str = '') -> dict[str, float]:
    """One rank's call of the program against the reference's: the worst
    step's loss, and the median and the 90th percentile leaf's gap of
    each kind of norm (the worst leaf swings with the noise of the later
    steps; ``detail`` adds it, and the first step's loss).  Each name
    starts with ``prefix``."""
    lp, lr = prog_losses.double().cpu(), ref_losses.double().cpu()
    loss = _gap(lp, lr) / lr.abs()
    leaves = {'grad': list(ref_norms['grad']), 'update': moved_leaves(ref_norms),
              'stat': list(ref_norms['stat'])}
    out = {'loss_gap': float(loss.max())}
    kinds = (('grad', 'grad_gap'), ('update', 'update_gap'),
             ('stat', 'stats_gap'))
    for kind, key in kinds:
        args = (prog_norms[kind], ref_norms[kind], leaves[kind])
        out[key] = _median_leaf(*args)
        out[key + '_p90'] = _p90_leaf(*args)
    if detail:
        out['first_loss_gap'] = float(loss[0])
        for kind, key in kinds:
            out[key + '.worst'] = _worst_leaf(
                prog_norms[kind], ref_norms[kind], leaves[kind])
    return {prefix + k: v for k, v in out.items()}


def judge(numbers: dict[str, float], limits: dict) -> dict[str, dict]:
    """Each number the cell's ``limits`` name beside its limit; ``ok``
    where it is at most the limit (a number that is missing is never
    ok)."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        ok = limit is not None and math.isfinite(value) and value <= limit
        out[name] = {'value': value, 'limit': limit, 'ok': ok}
    return out
