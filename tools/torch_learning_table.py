"""The PyTorch port's Cartpole learning table: ``results/summary_torch.json``
(``tools/summarize_results.py --out results/summary_torch.json`` over the
port's logs and curves) as the table of ``results/learning_table.md``, and
the episode timings the port's driver printed in each log (``episode k
took S s: fit F s (x ms a step), policy P s (y ms an iteration)``) beside
the card each run had (``card_<run>.txt``: ``nvidia-smi``'s name and power
limit, written by ``tools/torch_learning_run.sh``).

Usage::

    python tools/torch_learning_table.py [--results results]
        [--out results/learning_table_torch.md]

Numpy only, like ``summarize_results``.
"""
import argparse
import glob
import json
import os
import re
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from summarize_results import _fmt, group_stats  # noqa: E402

TIMING = re.compile(r'episode (\d+) took ([\d.]+) s: fit ([\d.]+) s '
                    r'\(([\d.]+) ms a step\), policy ([\d.]+) s '
                    r'\(([\d.]+) ms an iteration\)')
# the learning bands of RESULTS.md ("Reading"), for comparison only
BANDS = """\
Bands for comparison (`RESULTS.md`, "Reading"; the JAX package on one TPU
v5e chip and the torch reference on a CPU, same protocol; not targets):

- no-MM: JAX 5 of 6 seeds reach 20, at episodes 23 / 30 / 38 / 32 / 38
  (one peaks at a best eval of 17.9); the torch reference at 39 / 35; best
  evals 18-22 on both sides.
- MM (Cholesky): JAX all 7 runs at 9-16 episodes, best evals 30-33; the
  torch reference's three solving seeds at 18 / 17 / 12, best evals 32-33,
  its fourth never learned (best collected 0.17 in 40 episodes).
"""


def timings(log_path):
    """[(episode, s an episode, ms a fit step, ms a policy iteration)] from
    a port driver log."""
    with open(log_path, errors='replace') as fh:
        return [(int(m[0]), float(m[1]), float(m[3]), float(m[5]))
                for m in TIMING.findall(fh.read())]


def table(summary, threshold):
    lines = ['| run | best eval return (5-eval mean) | final-5 eval mean | '
             f'episodes to ≥{threshold} | best collected return | '
             'episodes run |', '|---|---|---|---|---|---|']
    for prefix in ('torch_no_mm', 'torch_mm'):
        for r in group_stats(summary, prefix + '_s', threshold) or []:
            eps = r['eps_to_thr']
            lines.append(
                f"| {r['run']} | {_fmt(r['best_eval'])} | "
                f"{_fmt(r['final5'])} | "
                f"{'not reached' if eps is None else eps} | "
                f"{_fmt(r['best_collect'])} | "
                f"{len(summary[r['run']]['collection_returns'])} |")
    return lines


def timing_table(results):
    lines = ['| run | episodes timed | s an episode (median; min-max) | '
             'ms a fit step (median) | ms a policy iteration (median) | '
             'card |', '|---|---|---|---|---|---|']
    for log in sorted(glob.glob(os.path.join(results, 'torch_*_s[0-9].log'))):
        t = timings(log)
        if not t:
            continue
        _, ep, fit, pol = map(np.asarray, zip(*t))
        run = os.path.basename(log)[:-4]
        card = os.path.join(results, f'card_{run}.txt')
        card = (open(card).read().strip() if os.path.exists(card)
                else 'not recorded')
        lines.append(f'| {run} | {len(t)} | '
                     f'{np.median(ep):.3f} ({ep.min():.3f}-{ep.max():.3f})'
                     f' | {np.median(fit):.4f} | {np.median(pol):.4f} | '
                     f'{card} |')
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--results', default=os.path.join(os.path.dirname(HERE),
                                                      'results'))
    ap.add_argument('--threshold', type=float, default=20.0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    with open(os.path.join(args.results, 'summary_torch.json')) as fh:
        summary = json.load(fh)
    text = '\n'.join(
        ['# Cartpole swing-up, the PyTorch port on one H100', '',
         'Made by `tools/torch_learning_table.py` from '
         '`results/summary_torch.json` and the logs `results/torch_*.log`. '
         'Every seed started is here. The port draws from its own '
         '`torch.Generator`s, so its seed k is not the JAX run k.',
         ''] + table(summary, args.threshold) + ['', BANDS, 'Episode '
         'timings the driver printed (host clock; the fit is host-bound, '
         'so they move with the host of each call):', '']
        + timing_table(args.results)) + '\n'
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(text)
    print(text)
    return text


if __name__ == '__main__':
    main()
