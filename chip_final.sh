# The final check of a change on the card, from the root of the checkout:
# chip_smoke.py alone in a directory (build/alone; must fail), then
# chip_smoke.py and the card's tests from an unpacked `git archive` of the
# staged tree in build/final, then rows 1-9's outputs of that tree against
# an unpacked parent in build/parent, bit for bit, and rows 3-9's with a
# mixture head of 2 and 5 components, and the mixture's distances from
# float64 (both reported; not a failure).
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
python3 tools/torch_kernel_outputs.py dump ../parent.pt --root ../parent > ../../chiprun_out/final_dump_parent.log 2>&1
python3 tools/torch_kernel_outputs.py dump ../change.pt > ../../chiprun_out/final_dump_change.log 2>&1
python3 tools/torch_kernel_outputs.py compare ../parent.pt ../change.pt > ../../chiprun_out/final_compare.log 2>&1; rc3=$?
echo "bits rc=$rc3"
tail -1 ../../chiprun_out/final_compare.log
python3 tools/torch_mixture_outputs.py dump ../parent_mix.pt --root ../parent > ../../chiprun_out/final_mix_parent.log 2>&1
python3 tools/torch_mixture_outputs.py dump ../change_mix.pt > ../../chiprun_out/final_mix_change.log 2>&1
python3 tools/torch_mixture_outputs.py compare ../parent_mix.pt ../change_mix.pt > ../../chiprun_out/final_mix_compare.log 2>&1
echo "mixture bits rc=$?"
tail -1 ../../chiprun_out/final_mix_compare.log
python3 tools/torch_mixture_precision.py > ../../chiprun_out/final_mix_precision.log 2>&1
echo "mixture precision rc=$?"
exit $(( rc || rc2 || rc3 ))
