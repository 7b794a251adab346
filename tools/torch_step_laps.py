#!/usr/bin/env python3
"""Time split of the rollout-step kernels (PERF.md rows 6-7) on the card:
copies ``prob_mbrl_tpu_torch/csrc`` to ``build/step_laps/csrc`` with
``%globaltimer`` laps of CTA 0 (the first CTA of cluster 0) in
``step_fwd_kernel`` and ``step_bwd_kernel`` (weight staging; per row tile the
staging of masks and noise, the policy walk, the action and the dynamics
input, the dynamics walk, nxt and the reward, the rows written out; the
moments of the cluster's rows; the backward's
gradient wrt the tile's pre-MM outputs, the backward walks of both MLPs with
the dW; the tickets and the last cluster's tail, that of whichever cluster
is last), builds it and prints the parts in ms per launch
at B = 100 and B = 5761 on ``chip_smoke.py``'s inputs, with the card's name
and power limit.

    python3 tools/torch_step_laps.py [--batches 100,5761]

Each lap adds a ``__syncthreads()`` and a read-modify-write of a device
counter (the part after it absorbs that), so the parts add up to a little
more than the committed kernel's time (``chip_smoke.py`` phase 2). The
backward's MM-adjoint sums are a launch of their own, not split here.
"""
import argparse
import ctypes
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from prob_mbrl_tpu_torch.ops.cuda import build  # noqa: E402
from prob_mbrl_tpu_torch.ops.cuda import fused_rollout as fr  # noqa: E402

PARTS = ['weight staging', 'masks + noise', 'policy walk',
         'action + dynamics input', 'dynamics walk', 'nxt + reward',
         'rows written', 'cluster moments', 'ticket', 'last cluster tail',
         'staging of the MM coefficients', 'gradient wrt pre-MM outputs',
         'reward + density VJP', 'dynamics backward walk',
         'squash + policy density VJP', 'policy backward walk + dW',
         'g_states', 'dW partials + ticket', 'last cluster dW sums']
FWD = PARTS[:10]
BWD = [PARTS[0]] + PARTS[10:12] + PARTS[1:6] + PARTS[12:]

LAP = '''
__device__ unsigned long long g_lap[32];

// With `on`, thread 0 adds the time since this CTA's last lap to
// g_lap[part] (part < 0: only start the clock).
__device__ __forceinline__ void slap(int part, bool on) {
  __shared__ unsigned long long last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (on && part >= 0) g_lap[part] += t - last;
    last = t;
  }
}

__device__ __forceinline__ void slap(int part) { slap(part, blockIdx.x == 0); }
'''


def patched():
    """(cluster_walk.cuh, fused_step.cu) with the laps; raises if a source
    no longer has a patched spot."""
    walk = (build.CSRC / 'cluster_walk.cuh').read_text()
    step = (build.CSRC / 'fused_step.cu').read_text()
    p = {name: i for i, name in enumerate(PARTS)}

    def rep(s, a, b, count=1):
        if s.count(a) != count:
            raise RuntimeError(f'the source changed: {a[:60]!r}')
        return s.replace(a, b)

    walk = rep(walk, 'namespace cg = cooperative_groups;\n',
               'namespace cg = cooperative_groups;\n' + LAP)
    # step_fwd (also the backward's recompute)
    walk = rep(walk, '  prefetch_wait();\n  mlp_fwd<kReluOnly>(c, st.pol,',
               f'  prefetch_wait();\n  slap({p["masks + noise"]});\n'
               '  mlp_fwd<kReluOnly>(c, st.pol,')
    walk = rep(walk, 'row0, nrows);\n  for (int e = tid; e < TR * U; e += nt) {'
               '\n    const int r = e / U, k = e - r * U;\n    const float mean',
               f'row0, nrows);\n  slap({p["policy walk"]});\n'
               '  for (int e = tid; e < TR * U; e += nt) {\n'
               '    const int r = e / U, k = e - r * U;\n    const float mean')
    walk = rep(walk, '  __syncthreads();\n  mlp_fwd<kReluOnly>(c, st.dyn,',
               f'  slap({p["action + dynamics input"]});\n'
               '  mlp_fwd<kReluOnly>(c, st.dyn,')
    walk = rep(walk, 'kTDout * TRP, row0, nrows);\n',
               f'kTDout * TRP, row0, nrows);\n  slap({p["dynamics walk"]});\n')
    walk = rep(walk, 'st.r_scale * ua))) : 0.f;\n  }\n  __syncthreads();\n}',
               'st.r_scale * ua))) : 0.f;\n  }\n'
               f'  slap({p["nxt + reward"]});\n}}')
    # step_vjp
    walk = rep(walk, '  __syncthreads();\n  // nxt = s + mean * sy + my',
               f'  slap({p["reward + density VJP"]});\n'
               '  // nxt = s + mean * sy + my')
    walk = rep(walk, 'c.lay.xd, nullptr);\n',
               f'c.lay.xd, nullptr);\n  slap({p["dynamics backward walk"]});\n')
    walk = rep(walk, '  __syncthreads();\n  const float* gp = mlp_bwd',
               f'  slap({p["squash + policy density VJP"]});\n'
               '  const float* gp = mlp_bwd')
    walk = rep(walk, 'c.lay.xp, dwacc);\n',
               f'c.lay.xp, dwacc);\n  slap({p["policy backward walk + dW"]});\n')
    walk = rep(walk, 'gp[k * TRP + r];\n    }\n  __syncthreads();\n}',
               f'gp[k * TRP + r];\n    }}\n  slap({p["g_states"]});\n}}')
    # both walk kernels start the clock
    step = rep(step, '  copy_params(st, lay, st_s, lay_s);\n',
               '  copy_params(st, lay, st_s, lay_s);\n  slap(-1);\n', 2)
    # step_fwd_kernel
    step = rep(step, '  stage(c, s, nullptr);\n',
               f'  stage(c, s, nullptr);\n  slap({p["weight staging"]});\n')
    step = rep(step, 'io.r_raw[row0 + r] = ts[kTR * TRP + r];\n  }\n',
               'io.r_raw[row0 + r] = ts[kTR * TRP + r];\n'
               f'    slap({p["rows written"]});\n  }}\n')
    step = rep(step, '  if (!last_cluster(io.tickets, kTicketFwd, rank, G, sh)) '
               'return;\n',
               f'  slap({p["cluster moments"]});\n'
               '  const bool is_last = last_cluster(io.tickets, kTicketFwd, rank, '
               'G, sh);\n'
               f'  slap({p["ticket"]});\n  if (!is_last) return;\n')
    step = rep(step, 'io.r[b] = sh.r.m[0] + s.z_rr[b] * sh.r.L[0];\n}',
               'io.r[b] = sh.r.m[0] + s.z_rr[b] * sh.r.L[0];\n'
               f'  slap({p["last cluster tail"]}, rank == 0);\n}}')
    # step_bwd_kernel
    step = rep(step, '  stage(c, s, dwacc);\n',
               f'  stage(c, s, dwacc);\n  slap({p["weight staging"]});\n')
    step = rep(step, '  __syncthreads();\n  float* gin = smem + tl.gin;',
               f'  slap({p["staging of the MM coefficients"]});\n'
               '  float* gin = smem + tl.gin;')
    step = rep(step, '    step_fwd<kReluOnly>(c, s, s.states + (size_t)row0 * D, '
               's.eps, row0, nrows, true);\n',
               f'    slap({p["gradient wrt pre-MM outputs"]});\n'
               '    step_fwd<kReluOnly>(c, s, s.states + (size_t)row0 * D, '
               's.eps, row0, nrows, true);\n')
    step = rep(step, '  if (G == 1) return;\n'
               '  if (!last_cluster(g.tickets, kTicketDw, c.rank, G, sh)) return;\n',
               '  if (G == 1) return;\n'
               '  const bool is_last = last_cluster(g.tickets, kTicketDw, c.rank, '
               'G, sh);\n'
               f'  slap({p["dW partials + ticket"]});\n  if (!is_last) return;\n')
    step = rep(step, 'g.db[l][i - din * dout] = v[u];\n    }\n  }\n}',
               'g.db[l][i - din * dout] = v[u];\n    }\n  }\n'
               f'  slap({p["last cluster dW sums"]}, c.rank == 0);\n}}')
    step = rep(step, 'extern "C" {\n', '''extern "C" {

// Copies the laps (ns, summed over launches) to out[32] and zeroes them.
int fused_step_laps(unsigned long long* out) {
  int e = cudaMemcpyFromSymbol(out, g_lap, sizeof(g_lap));
  if (e != cudaSuccess) return e;
  static const unsigned long long zero[32] = {};
  return cudaMemcpyToSymbol(g_lap, zero, sizeof(g_lap));
}
''')
    return walk, step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--batches', default='100,5761')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_step_laps: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    walk, step = patched()
    dst = build.BUILD_DIR / 'step_laps'
    csrc = dst / 'csrc'
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(build.CSRC, csrc)
    (csrc / 'cluster_walk.cuh').write_text(walk)
    (csrc / 'fused_step.cu').write_text(step)
    build.CSRC, build.BUILD_DIR = csrc, dst / 'lib'
    lib = fr._lib()
    lib.fused_step_laps.argtypes = [ctypes.c_void_p]
    lib.fused_step_laps.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 32)()

    def laps(fn, n=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        assert lib.fused_step_laps(buf) == 0
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        assert lib.fused_step_laps(buf) == 0
        return [buf[i] / n / 1e6 for i in range(len(PARTS))]

    def show(what, names, parts):
        got = [(nm, parts[PARTS.index(nm)]) for nm in names]
        print(f'{what}: ' + ', '.join(f'{nm} {ms:.4f} ms' for nm, ms in got)
              + f' = {sum(ms for _, ms in got):.4f} ms', flush=True)

    for B in [int(b) for b in args.batches.split(',')]:
        _, _, _, states, eps, cot, (k, zm, zr) = cs.step_problem(B, seed=7)
        res = k.forward(states, eps, zm, zr)[2:]
        fwd, bwd = k.plans()
        show(f'fused_step_fwd B={B} ({fwd.clusters} clusters, {fwd.tiles} '
             f'tiles of {fwd.tile_rows} rows)', FWD,
             laps(lambda: k.forward(states, eps, zm, zr)))
        show(f'fused_step_bwd walk B={B} ({bwd.clusters} clusters, '
             f'{bwd.tiles} tiles of {bwd.tile_rows} rows)', BWD,
             laps(lambda: k.backward(states, eps, zm, zr, *res, *cot, True)))
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
