"""Decide fault 1 from its rows: is the port's detector trainer worse than
the JAX package's at the synthetic chain's 64 / 60 row?

Each row of ``fault1_rows.json`` is one detector, trained by one package
from one init seed, run through the port's later stages with one pose net
(``synthetic_auc_probe.py``). The statistic is the window AUC, port rows
against JAX rows:

- the Hodges-Lehmann shift, the median of all port - JAX differences;
- its exact Mann-Whitney 95 % interval: the k-th smallest and k-th largest
  of the n*m differences, k one above the largest rank-sum count u with
  P(U <= u) <= 2.5 % under the exact null (no ties);
- Welch's difference of means and its 95 % interval, a second reading.

The rules, fixed before the rows were read:

- confirmed: the HL interval lies wholly below 0, and the sweep on the JAX
  detector (B1) does not read nearer the sweep on the port's (B2) than
  the JAX file's 0.9529;
- closed: the HL interval lies inside (-0.10, +0.10) and (B1) reads
  ``tok4`` >= 0.92;
- neither: any other reading. Seeds 10-13 are then added on each side,
  once (rows of ``round`` 2), and the rules applied again; what then
  stands is reported as it stands. Rows of ``round`` 3 (seeds 14-25, the
  motion rules' (iii)) are added the same way, once both sides have
  them for the same seeds.

It also reads which detector readings follow the AUC across all rows
(Spearman's rho).

The motion rules (rows re-run with ``fault1_motion.py``'s readings under
``motion``, the re-run's own window AUC under ``rerun``), fixed before
those rows were read:

- (i) over the port rows, Spearman's rho of each motion reading with the
  window AUC; the reading with the largest |rho| is *the reading* if
  |rho| >= 0.7;
- (ii) if there is one: the reading compared between the packages on
  JAX seeds 0-13 (PERF.md gives the band);
- (iii) if there is none: seeds 14-25 on each side (rows of ``round`` 3),
  and the rules above applied once to all rows.

The port's 14 rows read no reading at |rho| >= 0.7, so (ii) never ran.

Imports numpy and scipy only.

    python examples_torch/fault1_verdict.py [--rows examples_torch/fault1_rows.json]

Prints the readings and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from scipy import stats

ROWS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fault1_rows.json")
ALPHA = 0.05
MOTION_READINGS = ("kpt_motion_median", "kpt_motion_track_mean", "box_motion_median",
                   "box_motion_track_mean", "tracks_per_video", "frame_coverage",
                   "static_kpt_rms")  # fault1_motion.READINGS
RHO_FLOOR = 0.7     # rule (i): |rho| a reading must reach
CLOSE_BAND = 0.10   # the interval must lie inside (-0.10, +0.10) to close
B1_FLOOR = 0.92     # the sweep on the JAX detector must read at least this
JAX_FILE_TOK4 = 0.9529  # examples/sweep_extracted_results.json, tok4 at 256


def rank_sum_counts(n: int, m: int) -> np.ndarray:
    """counts[u]: how many of the C(n+m, n) orderings of n port and m JAX
    values have u (port, JAX) pairs with the port value above."""
    # table[i][j] is the count polynomial of i port and j JAX values
    table = [[np.ones(1, np.int64) for _ in range(m + 1)] for _ in range(n + 1)]
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            # the largest value is a port value (above all j JAX values) or a JAX one
            top_port = np.concatenate([np.zeros(j, np.int64), table[i - 1][j]])
            top_jax = table[i][j - 1]
            size = max(len(top_port), len(top_jax))
            table[i][j] = (np.pad(top_port, (0, size - len(top_port)))
                           + np.pad(top_jax, (0, size - len(top_jax))))
    return table[n][m]


def rank_k(n: int, m: int, alpha: float = ALPHA) -> int:
    """The interval's order statistic: one above the largest u with
    P(U <= u) <= alpha / 2 under the exact null; 0 where no u is that
    rare (too few rows: the interval is unbounded)."""
    counts = rank_sum_counts(n, m)
    cdf = np.cumsum(counts) / counts.sum()
    below = np.nonzero(cdf <= alpha / 2)[0]
    return int(below[-1]) + 1 if below.size else 0


def hodges_lehmann(port: Sequence[float], jax: Sequence[float],
                   alpha: float = ALPHA) -> Dict[str, float]:
    """HL shift of port - JAX and its exact Mann-Whitney interval."""
    d = np.sort(np.subtract.outer(np.asarray(port, float), np.asarray(jax, float)).ravel())
    k = rank_k(len(port), len(jax), alpha)
    lo, hi = (float(d[k - 1]), float(d[len(d) - k])) if k else (-np.inf, np.inf)
    return {"shift": float(np.median(d)), "lo": lo, "hi": hi, "k": k, "pairs": int(len(d))}


def welch(port: Sequence[float], jax: Sequence[float],
          alpha: float = ALPHA) -> Dict[str, float]:
    """Welch's difference of means (port - JAX) and its interval."""
    a, b = np.asarray(port, float), np.asarray(jax, float)
    va, vb = a.var(ddof=1) / len(a), b.var(ddof=1) / len(b)
    df = (va + vb) ** 2 / (va ** 2 / (len(a) - 1) + vb ** 2 / (len(b) - 1))
    half = float(stats.t.ppf(1 - alpha / 2, df) * np.sqrt(va + vb))
    diff = float(a.mean() - b.mean())
    return {"diff": diff, "lo": diff - half, "hi": diff + half, "df": float(df)}


def rule(hl: Dict[str, float], b1: Optional[float], b2: Optional[float]) -> str:
    """The verdict of one reading of the rules."""
    b1_near_b2 = (b1 is not None and b2 is not None
                  and abs(b1 - b2) < abs(b1 - JAX_FILE_TOK4))
    if hl["hi"] < 0 and not b1_near_b2:
        return "confirmed"
    if (-CLOSE_BAND < hl["lo"] and hl["hi"] < CLOSE_BAND
            and b1 is not None and b1 >= B1_FLOOR):
        return "closed"
    return "neither"


def sweep_mean(data: Dict[str, Any], key: str) -> Optional[float]:
    fits = (data.get("sweeps") or {}).get(key)
    return float(np.mean([f["window_auc"] for f in fits])) if fits else None


def window_aucs(rows: List[Dict[str, Any]], package: str) -> List[float]:
    return [r["window_auc"] for r in rows if r["package"] == package]


def decide(data: Dict[str, Any]) -> Dict[str, Any]:
    """Apply the rules to round 1, and once more with each later round
    (2: seeds 10-13; 3: seeds 14-25, the motion rules' (iii)) while the
    rounds before read 'neither' and both sides hold that round's rows for
    the same seeds."""
    b1, b2 = sweep_mean(data, "B1_jax_detector"), sweep_mean(data, "B2_port_phase_a")
    rows = [r for r in data["rows"] if r.get("round", 1) == 1]
    rounds = 1
    hl = hodges_lehmann(window_aucs(rows, "port"), window_aucs(rows, "jax"))
    verdict = rule(hl, b1, b2)
    for later in (2, 3):
        more = [r for r in data["rows"] if r.get("round", 1) == later]
        seeds = [{r["seed"] for r in more if r["package"] == p} for p in ("port", "jax")]
        if verdict != "neither" or not seeds[0] or seeds[0] != seeds[1]:
            break
        rows, rounds = rows + more, later
        hl = hodges_lehmann(window_aucs(rows, "port"), window_aucs(rows, "jax"))
        verdict = rule(hl, b1, b2)
    port, jax = window_aucs(rows, "port"), window_aucs(rows, "jax")
    return {"verdict": verdict, "rounds": rounds, "n_port": len(port), "n_jax": len(jax),
            "hl": hl, "welch": welch(port, jax), "b1_tok4": b1, "b2_tok4": b2,
            "port_mean": float(np.mean(port)), "jax_mean": float(np.mean(jax))}


def followers(rows: List[Dict[str, Any]]) -> Dict[str, float]:
    """Spearman's rho of the window AUC with each detector reading the rows
    carry, across all rows (None for a reading equal in every row)."""
    auc = [r["window_auc"] for r in rows]
    out = {}
    for key in ("windows", "recall", "map50_95", "kpt_rms_norm"):
        vals = [r.get(key) for r in rows]
        if all(v is not None for v in vals):
            # a reading equal in every row follows nothing
            out[key] = float(stats.spearmanr(auc, vals)[0]) if len(set(vals)) > 1 else None
    return out


def rule_i(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Rule (i): Spearman's rho of each motion reading with the re-run's
    window AUC over the port rows that ran again with it, and the reading
    that follows it, if any reaches RHO_FLOOR."""
    port = [r for r in rows if r["package"] == "port" and "rerun" in r]
    auc = [r["rerun"]["window_auc"] for r in port]
    rho = {}
    for key in MOTION_READINGS:
        vals = [r["motion"][key] for r in port]
        rho[key] = (float(stats.spearmanr(auc, vals)[0])
                    if len(port) > 2 and None not in vals and len(set(vals)) > 1 else None)
    ranges = {k: [min(r["motion"][k] for r in port), max(r["motion"][k] for r in port)]
              for k in MOTION_READINGS} if port else {}
    best = max((k for k in rho if rho[k] is not None), key=lambda k: abs(rho[k]), default=None)
    reading = best if best is not None and abs(rho[best]) >= RHO_FLOOR else None
    return {"n_port": len(port), "rho": rho, "ranges": ranges, "best": best, "reading": reading,
            "next": "(ii)" if reading else "(iii)"}


def motion_medians(rows: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Each package's median of each motion reading over its rows that
    carry one (a description beside the rules, which read the port rows)."""
    out = {}
    for package in ("port", "jax"):
        have = [r["motion"] for r in rows if r["package"] == package and "motion" in r]
        out[package] = {"rows": len(have), **{k: float(np.median([m[k] for m in have]))
                                              for k in MOTION_READINGS if have}}
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rows", default=ROWS)
    args = p.parse_args(argv)
    with open(args.rows) as f:
        data = json.load(f)
    res = decide(data)
    res["spearman_with_window_auc"] = followers(
        [r for r in data["rows"] if r.get("round", 1) <= res["rounds"]])
    res["rule_i"] = motion = rule_i(data["rows"])
    res["motion_medians"] = motion_medians(data["rows"])
    hl, w = res["hl"], res["welch"]
    print(f"rows: {res['n_port']} port, {res['n_jax']} JAX (round {res['rounds']})")
    print(f"means: port {res['port_mean']:.4f}, JAX {res['jax_mean']:.4f}")
    print(f"Hodges-Lehmann shift {hl['shift']:+.4f}, exact 95 % interval "
          f"[{hl['lo']:+.4f}, {hl['hi']:+.4f}] (k {hl['k']} of {hl['pairs']})")
    print(f"Welch {w['diff']:+.4f}, 95 % interval [{w['lo']:+.4f}, {w['hi']:+.4f}] "
          f"(df {w['df']:.1f})")
    print(f"sweep tok4 at 256: B1 (JAX detector) {res['b1_tok4']}, "
          f"B2 (port phase A) {res['b2_tok4']}")
    print(f"Spearman rho with the window AUC: {res['spearman_with_window_auc']}")
    print(f"verdict: {res['verdict']}")
    if motion["n_port"]:
        print(f"rule (i), {motion['n_port']} port rows: Spearman rho of each motion reading "
              f"with the window AUC {json.dumps(motion['rho'])}; the reading: "
              f"{motion['reading']} (largest |rho|: {motion['best']}); next {motion['next']}; "
              f"their ranges {json.dumps(motion['ranges'])}")
        print(f"motion medians by package: {json.dumps(res['motion_medians'])}")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
