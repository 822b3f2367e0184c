"""The program's OpenCV FM_LMEDS F table (fmat_source="opencv_lmeds")
against the plain reference (h100bench/lmeds_reference.py) on the same
7-point samples, at a configuration's full size.

    python3 tools/check_fmat_on_card.py \
        [--config h100bench/configs/dtu49_cvlmeds.json] [--seed 1] \
        [--device cuda] [--scene '{"n_cams": 6}'] [--out FILE]

It builds the configuration's seeded scene (h100bench/scenes.py), fits
every ordered pair with the program (refpoints.opencv_lmeds_fit: on the
card kernel K9, a chunk of pairs a launch, one chunk at dtu49; timed
twice, the first run loading the kernel library and the torch kernels
it first uses), fits each pair again with the reference on the
program's samples, and prints one JSON line: the fit's seconds and each
compared number beside its tolerance.  It exits 0 when
every number is within its tolerance, else 1.  `--scene` overrides keys
of the configuration's scene (a small scene for a rehearsal on the CPU).

The compared numbers (the worst over the pairs), and why each tolerance.
Readings: NVIDIA H100 80GB HBM3, dtu49_cvlmeds at full size, seeds 1,
2718281828 and 3 (PERF.md section 6).  The score tolerances were set
after the first readings on the card: a first draft held both at 1e-4,
which the program read at 4.1e-3 and 4.0e-4 (score) and 1.3e-4
(rescore), every pair on the same sample.  On a CPU, at 6 views, the two
sides agree to 1e-6, so the gap comes from the card's float64
arithmetic; which step of it was not isolated.

- `valid_mismatch`, at most 0: a pair fit by one side and not the other.
- `score_rel`: |program's score / reference's - 1|, at most 0.02.  On
  noise-free refpoints a score is the float32 rounding floor of the
  observations (an upper median of about 3.6e-10 px^2, a distance of
  1.9e-5 px), so it is as sensitive as a score can be: the two sides
  reach the same model by other float64 arithmetic (the program's null
  space by elimination in kernel K9, before it the card's batched SVD;
  closed-form roots against the interpolated cubic's companion
  eigenvalues), which leaves their F up to 2.5e-9 apart per entry (4e-11
  moves a line ~4e-8 px, 0.2% of the distance).  Read with K9: at most
  1.8e-4, 3.1e-4 and 1.0e-2, the program's model the better where they
  differ most (with the plain route before it 4.1e-3, 4.0e-4, 1.8e-3);
  the float32-solve copy 9.5.
- `rescore_rel`: the reference's upper median of the program's F, over
  the reference's score, less 1, at most 0.02: the chosen F itself is as
  good as the reference's best, whatever the program's score says.
  Read: at most 3.0e-4 with K9 (1.3e-4 with the plain route); the
  float32-solve copy 33.
- `f_same_sample`: where both chose the same sample, the largest entry
  difference of the two unit-Frobenius F up to sign, at most 1e-8: the
  same 7 points give the same model up to float64 rounding.  Read: at
  most 2.5e-9 with K9 (3.8e-10 with the plain route); the float32-solve
  copy 3.0e-5.
- `same_sample_share`: the share of pairs where both chose the same
  sample, at least 0.9: the same models win unless two samples score
  within rounding of each other.  Read: 1.0 on each seed; the
  float32-solve copy 0.012.

A copy of the plain estimator with the 7-point solve in float32 (ops/
geometry.py, fundamental_7point's dtype) fails all four of those.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from h100bench import lmeds_reference, scenes  # noqa: E402
from h100bench.run import edge_graph_config, program_scene  # noqa: E402

#: name -> (tolerance, "max" or "min")
TOLERANCES = dict(valid_mismatch=(0, "max"), score_rel=(0.02, "max"),
                  rescore_rel=(0.02, "max"), f_same_sample=(1e-8, "max"),
                  same_sample_share=(0.9, "min"))


def dense(scene):
    """The refpoint observations as (xy [N, V, 2] float32, as
    cv::Point2f holds them, and mask [N, V])."""
    N, V = len(scene.obs_cam), scene.n_cameras
    xy = np.zeros((N, V, 2), np.float32)
    mask = np.zeros((N, V), bool)
    for p, (cams, obs) in enumerate(zip(scene.obs_cam, scene.obs_xy)):
        xy[p, cams] = obs
        mask[p, cams] = True
    return xy, mask


def common_points(xy, mask, i: int, j: int):
    """The observations of views i and j of the refpoints both hold, in
    point order."""
    both = np.flatnonzero(mask[:, i] & mask[:, j])
    return xy[both, i], xy[both, j]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def compare(fit, ref, points, device) -> dict:
    """The compared numbers of the program's fit against the reference's
    per-pair results."""
    valid = fit.valid.numpy()
    ref_ok = np.array([r["F"] is not None for r in ref])
    both = valid & ref_ok
    score, rescore, f_same, same = [0.0], [0.0], 0.0, []
    for p in np.flatnonzero(both):
        r, s = ref[p], float(fit.score[p])
        score.append(s / r["score"] - 1)
        x1, x2 = (torch.as_tensor(a, device=device) for a in points[p])
        F = fit.F[p].to(device)[None]
        again = float(lmeds_reference.upper_median(
            lmeds_reference.opencv_error(F, x1, x2))[0])
        rescore.append(again / r["score"] - 1)
        same.append(int(fit.best[p]) // 3 == r["sample"])
        if same[-1]:
            Fp = fit.F[p].numpy()
            f_same = max(f_same, min(np.abs(Fp - r["F"]).max(),
                                     np.abs(Fp + r["F"]).max()))
    return dict(valid_mismatch=int((valid != ref_ok).sum()),
                score_rel=max(abs(v) for v in score),
                rescore_rel=max(rescore), f_same_sample=f_same,
                same_sample_share=float(np.mean(same)) if same else 0.0,
                score_rel_range=[min(score), max(score)],
                rescore_rel_range=[min(rescore), max(rescore)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=os.path.join(
        ROOT, "h100bench", "configs", "dtu49_cvlmeds.json"))
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scene", default="{}")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from edgegraph3d_tpu_torch.matching import refpoints

    with open(args.config) as f:
        conf = json.load(f)
    spec = dict(conf["scene"], **json.loads(args.scene))
    scene = scenes.make(spec, args.seed)
    cfg = edge_graph_config(conf)
    sfmd = program_scene(scene)
    fit_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        fit = refpoints.opencv_lmeds_fit(sfmd, cfg, args.device)
        sync(args.device)
        fit_s.append(time.perf_counter() - t0)
    xy, mask = dense(scene)
    points = [common_points(xy, mask, int(i), int(j))
              for i, j in fit.pairs]
    t0 = time.perf_counter()
    ref = lmeds_reference.fit_pairs(points, fit.samples, args.device)
    ref_s = time.perf_counter() - t0
    nums = compare(fit, ref, points, args.device)
    checks = {}
    for name, (tol, sense) in TOLERANCES.items():
        v = nums[name]
        checks[name] = dict(value=v, tolerance=tol,
                            ok=bool(v <= tol if sense == "max"
                                    else v >= tol))
    dev = (torch.cuda.get_device_name(0)
           if torch.device(args.device).type == "cuda" else "cpu")
    res = dict(device=dev, seed=args.seed, pairs=len(fit.pairs),
               trials=int(fit.samples.shape[1]),
               points=int(fit.n_common.max()) if len(fit.pairs) else 0,
               fit_s=fit_s, reference_s=ref_s,
               models=int(fit.models.sum()),
               samples_no_model=int(fit.no_model.sum()),
               score_median=float(fit.score[fit.valid].median())
               if bool(fit.valid.any()) else None,
               score_rel_range=nums["score_rel_range"],
               rescore_rel_range=nums["rescore_rel_range"],
               checks=checks, ok=all(c["ok"] for c in checks.values()))
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
