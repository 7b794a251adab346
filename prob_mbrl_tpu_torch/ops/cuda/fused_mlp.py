"""Fused dropout-MLP: hand-written CUDA kernels for Hopper, and their plain
PyTorch version.

Counterpart of ``prob_mbrl_tpu/ops/pallas/fused_mlp.py``. The whole
Linear -> activation -> dropout-mask chain runs in one kernel
(``csrc/fused_mlp.cu``: ``fused_mlp_fwd`` replaces ``_fwd_kernel``,
``fused_mlp_bwd`` replaces ``_bwd_kernel``); the source says what bounds them
and how they are laid out: thread-block clusters walk tiles of batch rows,
each layer's weight rows split over a cluster's CTAs. ``launch_plan`` sizes
the launch from the widths and the batch; ``max_clusters`` asks the card how
many clusters of it fit, and a launch raises if not one does. Masks are
differentiable inputs: the backward returns ``d(mask) = g_h * act(a)``,
which carries the straight-through concrete-dropout gradient to
``logit_p`` outside the kernel.

``compute_dtype='bfloat16'`` runs the kernels' bf16-operand instances, as
the Pallas kernel's ``compute_dtype`` does: each product rounds both of its
operands to bf16 and accumulates in float32 (the forward's ``x W_l``, the
backward's ``h_l^T g_a`` and ``g_a W_l^T``); bias, activation and its VJP,
masks, d(mask), db, the saved pre-activations, the activations between
layers and every output stay float32.

``fused_mlp`` launches the kernels for CUDA tensors and raises if it cannot.
For CPU tensors it runs the plain version ``fused_mlp_plain``, whose gradients
come from autograd (with bf16 operands, from a backward that rounds where
the kernel does); that is the only case in which the plain version stands in
for a kernel.
"""
import collections
import ctypes
import functools

import torch

from ...models.activations import get as get_act
from . import build

# order = the Act enum of csrc/fused_mlp.cu
KERNEL_ACTS = ('relu', 'swish', 'exp', 'sin', 'sinlu', 'tanh', 'identity')
MAX_LAYERS = 8      # kMaxLayers: linear layers, hidden + output
MAX_WIDTH = 1000    # kMaxWidth

# launches of each kernel since the last reset_launch_counts(): the float32
# instances, and the bf16-operand ones
LAUNCHES = {'fused_mlp_fwd': 0, 'fused_mlp_bwd': 0}
LAUNCHES_BF16 = {'fused_mlp_fwd_bf16': 0, 'fused_mlp_bwd_bf16': 0}


def reset_launch_counts():
    for counts in (LAUNCHES, LAUNCHES_BF16):
        for k in counts:
            counts[k] = 0


def fused_mlp_supported(dims, nonlins):
    """True if the fused kernel takes this MLP configuration.

    ``dims``: the widths from input to output, ``(d0, *hidden, d_out)``.
    """
    if not 3 <= len(dims) <= MAX_LAYERS + 1 or max(dims) > MAX_WIDTH:
        return False
    return all(isinstance(nl, str) and nl in KERNEL_ACTS for nl in nonlins)


# ---------------------------------------------------------------------------
# launch plan (csrc/fused_mlp.cu checks it against the same formulas)
# ---------------------------------------------------------------------------

CLUSTER = 8           # kCluster: CTAs per thread-block cluster
ROW_GROUP = 4         # RB: rows of a thread's item
FWD_ITEMS = 8         # kMaxItems: forward product items a thread may hold
MIN_THREADS = 256
MAX_THREADS = 512     # kMaxThreads
MAX_STAGES = 8        # kMaxStages: depth of the weight ring
MAX_TILE_ROWS = 128   # kMaxTileRows
STAGE_MAX = 8192      # floats of a ring stage, at most (but a whole row)
SMEM_MAX = 232448     # shared memory a CTA may use on Hopper
TARGET_CLUSTERS = 15  # clusters of 8 CTAs an H100 holds at once
SCRATCH_MAX = 1 << 25  # floats of dW and db partials (128 MiB)

# field order = the PlanField enum of csrc/fused_mlp.cu
Plan = collections.namedtuple('Plan', [
    'cluster', 'tile_rows', 'row_tiles', 'clusters', 'threads', 'stage',
    'fwd_stages', 'fwd_smem', 'bwd_stages', 'bwd_smem', 'scratch'])


def _cdiv(a, b):
    return -(-a // b)


def operand_dtype(compute_dtype):
    """The kernels' operand dtype for ``compute_dtype``: None (float32) for
    None or float32, ``torch.bfloat16`` for bf16; raises for any other."""
    if compute_dtype is None:
        return None
    dt = compute_dtype
    if not isinstance(dt, torch.dtype):
        dt = getattr(torch, str(compute_dtype), None)
    if dt == torch.float32:
        return None
    if dt != torch.bfloat16:
        raise ValueError(f'the fused kernels take compute_dtype None, float32 '
                         f'or bfloat16, not {compute_dtype!r}')
    return dt


@functools.lru_cache(maxsize=None)
def launch_plan(dims, B, bf16=False):
    """The kernels' launch plan for an MLP of widths ``dims`` at batch B,
    with float32 or (``bf16``) bf16 operands.

    ``row_tiles`` tiles of ``tile_rows`` batch rows, walked by ``clusters``
    clusters of ``CLUSTER`` CTAs (cluster c takes tiles c, c + clusters,
    ...; the grid is ``CLUSTER * clusters`` CTAs) of ``threads`` threads.
    CTA r owns rows [r kw, (r + 1) kw) of each W_l, kw = ceil(d_l /
    CLUSTER), and streams them through a ring of ``*_stages`` stages of
    ``stage`` elements (whole rows, plus 4 for the 16-byte phase), each of 4
    bytes, or of 2 with ``bf16``, whose ring is bf16. Besides
    the ring, a forward CTA holds two sets of partials [CLUSTER, kw, rows]
    and its slice of the layer input [kw, rows]; a backward CTA two
    gathered g_a tiles [d, rows] and its slice of the layer input; rows are
    padded by 4. ``*_smem``: bytes of shared memory per CTA. ``scratch``:
    floats of the dW and db partials, one [d_l + 1, d_{l+1}] per layer and
    cluster (0 with one cluster, whose partials are dW and db). Tiles of up
    to ``MAX_TILE_ROWS`` rows aim at ``TARGET_CLUSTERS`` clusters, fewer
    rows where threads or shared memory run short; clusters are fewer than
    tiles where the partials would pass ``SCRATCH_MAX`` floats.
    """
    dims = tuple(int(d) for d in dims)
    B = int(B)
    wb = 2 if bf16 else 4  # bytes of a ring element
    layers = list(zip(dims[:-1], dims[1:]))
    kw = max(_cdiv(d, CLUSTER) for d in dims)
    gw = max(dims[1:])
    block = max(_cdiv(a, CLUSTER) * b for a, b in layers)
    stage = 4 * _cdiv(max(min(STAGE_MAX, block), gw) + 4, 4)
    n_stages = sum(max(1, _cdiv(_cdiv(a, CLUSTER), max(1, (stage - 4) // b)))
                   for a, b in layers)
    tr = min(MAX_TILE_ROWS, ROW_GROUP * _cdiv(_cdiv(B, TARGET_CLUSTERS),
                                              ROW_GROUP))
    while True:
        groups, trp = tr // ROW_GROUP, tr + 4
        # a thread holds up to FWD_ITEMS forward product items (one where
        # MAX_THREADS allow), one forward epilogue item (groups * kw at
        # most) and one backward item
        items = max(_cdiv(groups * gw, FWD_ITEMS), groups * kw)
        threads = min(MAX_THREADS, max(MIN_THREADS, 32 * _cdiv(
            max(items, groups * gw), 32)))
        fixed_f = 2 * CLUSTER * kw * trp + kw * trp
        fixed_b = 2 * gw * trp + kw * trp
        ns_f = min(MAX_STAGES, n_stages,
                   (SMEM_MAX - 4 * fixed_f) // (wb * stage))
        ns_b = min(MAX_STAGES, n_stages,
                   (SMEM_MAX - 4 * fixed_b) // (wb * stage))
        if ns_f >= 2 and ns_b >= 2 and items <= threads:
            break
        if tr == ROW_GROUP:
            raise ValueError(f'no launch plan holds dims {dims}')
        tr -= ROW_GROUP
    tiles = _cdiv(B, tr)
    per_cluster = sum((a + 1) * b for a, b in layers)
    clusters = max(1, min(tiles, TARGET_CLUSTERS, SCRATCH_MAX // per_cluster))
    scratch = 0 if clusters == 1 else clusters * per_cluster
    return Plan(CLUSTER, tr, tiles, clusters, threads, stage,
                ns_f, 4 * fixed_f + wb * ns_f * stage,
                ns_b, 4 * fixed_b + wb * ns_b * stage, scratch)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _operand(t):
    """t rounded to bf16 (round to nearest even), kept in float32."""
    return t.to(torch.bfloat16).to(t.dtype)


class _PlainBF16(torch.autograd.Function):
    """The plain version with bf16 operands: the Pallas kernel's forward
    (``_fwd_kernel``, ``fused_mlp.py:92-104``) and its backward
    (``_bwd_kernel``, ``:146-176``), which rounds the operands of each
    product. Autograd through the forward's rounding would round the
    cotangents after the products instead; hence this backward."""

    @staticmethod
    def forward(ctx, cfg, x, *flat):
        nonlins, has_b, has_m = cfg
        n = len(nonlins)
        it = iter(flat)
        ws = [next(it) for _ in range(n + 1)]
        bs = [next(it) if hb else None for hb in has_b]
        ms = [next(it) if hm else None for hm in has_m]
        h, a_res = x, []
        for i in range(n + 1):
            a = _operand(h) @ _operand(ws[i])
            if bs[i] is not None:
                a = a + bs[i]
            if i == n:
                break
            a_res.append(a)
            h = get_act(nonlins[i])(a)
            if ms[i] is not None:
                h = h * ms[i]
        ctx.cfg = cfg
        ctx.save_for_backward(x, *ws, *[m for m in ms if m is not None],
                              *a_res)
        return a

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        nonlins, has_b, has_m = ctx.cfg
        n = len(nonlins)
        it = iter(ctx.saved_tensors)
        x = next(it)
        ws = [next(it) for _ in range(n + 1)]
        ms = [next(it) if hm else None for hm in has_m]
        a_res = [next(it) for _ in range(n)]

        def mm(a, b):
            return _operand(a) @ _operand(b)

        posts = [get_act(nl)(a) for nl, a in zip(nonlins, a_res)]
        hs = [x] + [p if m is None else p * m for p, m in zip(posts, ms)]
        dws, dbs, dms = [None] * (n + 1), [None] * (n + 1), [None] * n
        g_a = g
        for i in range(n, -1, -1):
            dws[i] = mm(hs[i].T, g_a)
            if has_b[i]:
                dbs[i] = g_a.sum(0)
            g_h = mm(g_a, ws[i].T)
            if i == 0:
                break
            g_post = g_h
            if ms[i - 1] is not None:
                dms[i - 1] = g_h * posts[i - 1]
                g_post = g_h * ms[i - 1]
            with torch.enable_grad():
                a = a_res[i - 1].detach().requires_grad_(True)
                (g_a,) = torch.autograd.grad(get_act(nonlins[i - 1])(a), a,
                                             g_post)
        return (None, g_h, *dws, *[d for d in dbs if d is not None],
                *[d for d in dms if d is not None])


def fused_mlp_plain(x, ws, bs, masks, nonlins, compute_dtype=None):
    """Plain PyTorch version of ``fused_mlp``, differentiated by autograd;
    with bf16 ``compute_dtype``, ``_PlainBF16``."""
    if operand_dtype(compute_dtype) is not None:
        cfg = (tuple(nonlins), tuple(b is not None for b in bs),
               tuple(m is not None for m in masks))
        return _PlainBF16.apply(cfg, x, *_flat(ws, bs, masks))
    n = len(ws) - 1
    h = x
    for i in range(n + 1):
        a = h @ ws[i]
        if bs[i] is not None:
            a = a + bs[i]
        if i == n:
            return a
        h = get_act(nonlins[i])(a)
        if masks[i] is not None:
            h = h * masks[i]


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _lib():
    lib = build.load('fused_mlp')
    if not getattr(lib, 'typed', False):
        i, p = ctypes.c_int, ctypes.c_void_p
        ip, pp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
        lib.fused_mlp_fwd.argtypes = [i, i, ip, ip, i, pp, pp, pp, pp, p, p,
                                      ip, p]
        lib.fused_mlp_fwd.restype = i
        lib.fused_mlp_bwd.argtypes = [i, i, ip, ip, i, pp, pp, pp, p, p, p,
                                      pp, pp, pp, p, ip, p]
        lib.fused_mlp_bwd.restype = i
        lib.fused_mlp_max_clusters.argtypes = [i, i, i, i, ip]
        lib.fused_mlp_max_clusters.restype = i
        lib.fused_mlp_error.argtypes = [i]
        lib.fused_mlp_error.restype = ctypes.c_char_p
        lib.typed = True
    return lib


def _ptrs(ts):
    return (ctypes.c_void_p * max(len(ts), 1))(
        *[None if t is None else t.data_ptr() for t in ts])


def _ints(vals):
    return (ctypes.c_int * max(len(vals), 1))(*vals)


def _raise(lib, name, rc):
    raise RuntimeError(f'{name} failed: {rc} '
                       f'({lib.fused_mlp_error(rc).decode()})')


def _check(lib, name, rc, bf16=False):
    if rc != 0:
        _raise(lib, name, rc)
    if bf16:
        LAUNCHES_BF16[name + '_bf16'] += 1
    else:
        LAUNCHES[name] += 1


def _validate(x, ws, bs, masks, nonlins):
    """Shapes for every device; type, device and layout for the kernels."""
    n = len(ws) - 1
    if n < 1 or len(bs) != n + 1 or len(masks) != n or len(nonlins) != n:
        raise ValueError('fused_mlp needs n+1 weights and biases and n masks '
                         'and activations, n >= 1')
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f'x must be [B, d0] with B >= 1, got {tuple(x.shape)}')
    B = x.shape[0]
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    for i, w in enumerate(ws):
        if tuple(w.shape) != (dims[i], dims[i + 1]):
            raise ValueError(f'weight {i} has shape {tuple(w.shape)}, '
                             f'expected {(dims[i], dims[i + 1])}')
        if bs[i] is not None and tuple(bs[i].shape) != (dims[i + 1],):
            raise ValueError(f'bias {i} has shape {tuple(bs[i].shape)}')
    for i, m in enumerate(masks):
        if m is not None and tuple(m.shape) != (B, dims[i + 1]):
            raise ValueError(f'mask {i} has shape {tuple(m.shape)}, '
                             f'expected {(B, dims[i + 1])}')
    if x.device.type == 'cpu':
        return 'cpu'
    if x.device.type != 'cuda':
        raise ValueError(f'fused_mlp runs on cuda (kernel) or cpu (plain '
                         f'version), not {x.device}')
    if n + 1 > MAX_LAYERS or max(dims) > MAX_WIDTH:
        raise ValueError(f'the kernel takes at most {MAX_LAYERS} layers of '
                         f'width <= {MAX_WIDTH}, got dims {dims}')
    bad = [nl for nl in nonlins if nl not in KERNEL_ACTS]
    if bad:
        raise ValueError(f'activations {bad} are not in the kernel set')
    for t in [x, *ws, *bs, *masks]:
        if t is None:
            continue
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError('the kernel takes float32 tensors on one device')
        if not t.is_contiguous():
            raise ValueError('the kernel takes contiguous tensors')
    return 'cuda'


_CLUSTERS = {}  # (device, kernel, bf16, threads, smem) -> clusters held


def max_clusters(device, backward, threads, smem, bf16=False):
    """Clusters of the forward (or backward) kernel, of float32 or
    (``bf16``) bf16 operands, that the card holds at once with ``threads``
    threads and ``smem`` bytes of shared memory per CTA
    (``cudaOccupancyMaxActiveClusters``); raises on a CUDA error."""
    key = (torch.device(device).index, bool(backward), bool(bf16), threads,
           smem)
    if key not in _CLUSTERS:
        lib = _lib()
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.fused_mlp_max_clusters(int(backward), int(bf16), threads,
                                            smem, ctypes.byref(n))
        if rc != 0:
            _raise(lib, 'fused_mlp_max_clusters', rc)
        _CLUSTERS[key] = n.value
    return _CLUSTERS[key]


def _fits(device, plan, backward, bf16=False):
    """Raises unless the card holds one cluster of the plan's kernel."""
    smem = plan.bwd_smem if backward else plan.fwd_smem
    if max_clusters(device, backward, plan.threads, smem, bf16) < 1:
        raise RuntimeError(
            f'the card cannot hold a cluster of {plan.cluster} CTAs of '
            f'{plan.threads} threads and {smem} bytes of shared memory '
            f'({"backward" if backward else "forward"} kernel)')


def _fwd_cuda(x, ws, bs, masks, nonlins, bf16=False):
    lib = _lib()
    n = len(ws) - 1
    B = x.shape[0]
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    plan = launch_plan(tuple(dims), B, bf16)
    _fits(x.device, plan, False, bf16)
    out = torch.empty((B, dims[-1]), device=x.device, dtype=x.dtype)
    a_res = [torch.empty((B, dims[i + 1]), device=x.device, dtype=x.dtype)
             for i in range(n)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_mlp_fwd(
            n, B, _ints(dims), _ints([KERNEL_ACTS.index(a) for a in nonlins]),
            int(bf16), _ptrs(ws), _ptrs(bs), _ptrs(masks), _ptrs(a_res),
            x.data_ptr(), out.data_ptr(), _ints(plan), stream)
    _check(lib, 'fused_mlp_fwd', rc, bf16)
    return out, a_res


def _bwd_cuda(x, ws, has_b, masks, a_res, nonlins, g, bf16=False):
    lib = _lib()
    n = len(ws) - 1
    B = x.shape[0]
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    plan = launch_plan(tuple(dims), B, bf16)
    _fits(x.device, plan, True, bf16)

    def empty(*shape):
        return torch.empty(shape, device=x.device, dtype=x.dtype)

    dx = empty(B, dims[0])
    dws = [empty(dims[i], dims[i + 1]) for i in range(n + 1)]
    dbs = [empty(dims[i + 1]) if has_b[i] else None for i in range(n + 1)]
    dms = [None if masks[i] is None else empty(B, dims[i + 1])
           for i in range(n)]
    scratch = empty(plan.scratch) if plan.scratch else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_mlp_bwd(
            n, B, _ints(dims), _ints([KERNEL_ACTS.index(a) for a in nonlins]),
            int(bf16), _ptrs(ws), _ptrs(masks), _ptrs(a_res), x.data_ptr(),
            g.data_ptr(), dx.data_ptr(), _ptrs(dws), _ptrs(dbs), _ptrs(dms),
            None if scratch is None else scratch.data_ptr(), _ints(plan),
            stream)
    _check(lib, 'fused_mlp_bwd', rc, bf16)
    return dx, dws, dbs, dms


class _FusedMLP(torch.autograd.Function):
    """Autograd wrapper of the kernels (CUDA tensors only): forward is
    ``fused_mlp_fwd``, backward is ``fused_mlp_bwd``, of float32 or bf16
    operands (``cfg``'s last entry).

    Gradient inputs are x, the weights, the present biases and the present
    masks, as in the JAX ``custom_vjp``.
    """

    @staticmethod
    def forward(ctx, cfg, x, *flat):
        nonlins, has_b, has_m, bf16 = cfg
        n = len(nonlins)
        it = iter(flat)
        ws = [next(it) for _ in range(n + 1)]
        bs = [next(it) if hb else None for hb in has_b]
        ms = [next(it) if hm else None for hm in has_m]
        out, a_res = _fwd_cuda(x, ws, bs, ms, nonlins, bf16)
        ctx.cfg = cfg
        ctx.save_for_backward(x, *ws, *[m for m in ms if m is not None],
                              *a_res)
        return out

    @staticmethod
    def backward(ctx, g):
        nonlins, has_b, has_m, bf16 = ctx.cfg
        n = len(nonlins)
        it = iter(ctx.saved_tensors)
        x = next(it)
        ws = [next(it) for _ in range(n + 1)]
        ms = [next(it) if hm else None for hm in has_m]
        a_res = [next(it) for _ in range(n)]
        dx, dws, dbs, dms = _bwd_cuda(x, ws, has_b, ms, a_res, nonlins,
                                      g.contiguous(), bf16)
        return (None, dx, *dws, *[d for d in dbs if d is not None],
                *[d for d in dms if d is not None])


def _flat(ws, bs, masks):
    return ([*ws] + [b for b in bs if b is not None]
            + [m for m in masks if m is not None])


def fused_mlp(x, ws, bs, masks, nonlins, compute_dtype=None):
    """Fully fused dropout-MLP forward (differentiable).

    Args:
      x: [B, d0] input batch (callers flatten leading dims).
      ws: n+1 weight matrices [(d_i, d_{i+1})].
      bs: n+1 biases ([d_{i+1}]) or None entries.
      masks: n multiplicative post-activation dropout masks ([B, d_{i+1}]) or
        None entries; differentiable inputs.
      nonlins: n activation names from ``KERNEL_ACTS``.
      compute_dtype: None (float32 operands) or bf16 (``operand_dtype``):
        each product rounds its operands to bf16 and accumulates in float32.

    Returns:
      [B, d_out] float32 output (before any output nonlinearity).
    """
    bf16 = operand_dtype(compute_dtype) is not None
    if _validate(x, ws, bs, masks, nonlins) == 'cpu':
        return fused_mlp_plain(x, ws, bs, masks, nonlins, compute_dtype)
    cfg = (tuple(nonlins), tuple(b is not None for b in bs),
           tuple(m is not None for m in masks), bf16)
    return _FusedMLP.apply(cfg, x, *_flat(ws, bs, masks))
