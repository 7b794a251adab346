#!/usr/bin/env python3
"""Build ``tools/torch_cluster_probe.cu`` with ``nvcc`` (sm_90a) into
``build/`` and run it: cooperative launches of thread-block clusters, grid
barriers across clusters, cluster barriers and cluster occupancy on the
card. Prints the card's name and power limit first.

    python3 tools/torch_cluster_probe.py
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from prob_mbrl_tpu_torch.ops.cuda import build  # noqa: E402


def main():
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out = build.BUILD_DIR / 'torch_cluster_probe'
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
                    '-std=c++17', '-O3', '-o', str(out),
                    str(ROOT / 'tools' / 'torch_cluster_probe.cu')],
                   check=True)
    return subprocess.run([str(out)], timeout=300).returncode


if __name__ == '__main__':
    sys.exit(main())
