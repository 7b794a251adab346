#!/bin/bash
# One learning run of the PyTorch port on the card and its replay, as the
# records under results/ (torch_*_s<k>.log, curves_torch_*_s<k>.json,
# card_torch_*_s<k>.txt) were made:
#
#   bash tools/torch_learning_run.sh NAME MODULE SEED PS_ITERS [OUT]
#   e.g. bash tools/torch_learning_run.sh torch_mm deep_pilco_mm 1 25 out/runs
#
# from the root of the checkout. It writes under OUT (default runs/out):
# the card's name and power limit, the driver's log at the full defaults
# of utils/experiments.py, the stochastic replay of every policy snapshot
# (tools/torch_eval_curves.py, 5 evals, eval seed 1234) and the run's
# folder; the built libraries go to OUT/buildcache. Libraries put back in
# build/buildcache/ from an earlier run are reused: they are touched so
# that the build, which compares modification times, takes them.
set -o pipefail
NAME=$1; MOD=$2; SEED=$3; PS=$4; OUT=${5:-runs/out}
RUN=${NAME}_s${SEED}
mkdir -p $OUT runs $OUT/buildcache
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee $OUT/card_$RUN.txt
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
if ls build/buildcache/*.so >/dev/null 2>&1; then cp build/buildcache/*.so build/ && touch build/*.so; fi
python -c "
import time
from prob_mbrl_tpu_torch.ops.cuda import build
t = time.time(); logs = build.build(['fused_mlp', 'fused_step', 'fused_rollout'])
print('[build]', {k: bool(v) for k, v in logs.items()}, f'{time.time() - t:.1f} s', flush=True)
" || exit 1
[ -d build/buildcache ] || cp build/libfused_mlp.so build/libfused_step.so build/libfused_rollout.so $OUT/buildcache/
t0=$(date +%s.%N)
python -m prob_mbrl_tpu_torch.examples.$MOD --seed $SEED --ps_iters $PS -o runs/$RUN 2>&1 | tee $OUT/$RUN.log || exit 1
t1=$(date +%s.%N)
echo "[learn] $RUN wall $(python -c "print($t1 - $t0)") s" | tee -a $OUT/wall_$RUN.txt
python tools/torch_eval_curves.py --run_dir runs/$RUN --n_evals 5 --eval_seed 1234 --out $OUT/curves_$RUN.json 2>&1 | tee $OUT/eval_$RUN.txt || exit 1
t2=$(date +%s.%N)
echo "[replay] $RUN wall $(python -c "print($t2 - $t1)") s" | tee -a $OUT/wall_$RUN.txt
cp -r runs/$RUN $OUT/rundir_$RUN
