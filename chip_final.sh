set -o pipefail
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
(cd build/alone && python3 chip_smoke.py > ../../chiprun_out/alone.log 2>&1; echo "alone rc=$?")
cd build/final
t0=$(date +%s)
python3 chip_smoke.py > ../../chiprun_out/final_smoke.log 2> ../../chiprun_out/final_smoke.err; rc=$?
echo "smoke rc=$rc in $(( $(date +%s) - t0 )) s"
tail -c 1500 ../../chiprun_out/final_smoke.log
t0=$(date +%s)
python3 -m pytest --noconftest tests/test_torch_cuda.py -q -p no:cacheprovider > ../../chiprun_out/final_cuda.log 2>&1; rc2=$?
echo "card tests rc=$rc2 in $(( $(date +%s) - t0 )) s"
tail -5 ../../chiprun_out/final_cuda.log
