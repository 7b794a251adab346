"""Ranks, the mesh handle and the collectives of particle sharding
(counterpart of ``prob_mbrl_tpu/parallel/sharding.py``).

JAX shards the imagined particles over a 1-D device mesh inside one program.
The port runs one process per shard (a *rank*) on ``torch.distributed``:
``launch`` spawns the ranks, each of which calls ``init_process_group`` and
gets a ``Mesh`` (its rank, the world size, the group, its device and the
backend), the counterpart of JAX's ``Mesh`` wherever a signature takes
``mesh=``. Parameters are replicated (every rank holds the same bits and
takes the same optimizer step); particles, their noise and minibatch rows
are split into equal contiguous slices (``shard_particles``); the sums that
cross shards are all-reduces (``all_reduce_``, ``mean_all_reduce``).

The backend is the caller's choice, never picked here: ``'nccl'`` where each
rank has a card of its own, ``'gloo'`` where ranks share a card or run on the
CPU (NCCL refuses two ranks on one device). A rank's device is
``cuda:{rank % device_count}``, or the CPU when the caller says ``'cpu'``.
The ranks start with the ``spawn`` method (a forked child would inherit the
parent's threads and CUDA state) and meet through a file in a temporary
directory, so no TCP port is taken and two launches never race for one.

``COLLECTIVES`` counts each rank's all-reduces and all-gathers since the last
``reset_collective_counts()`` (``same_on_every_rank``'s check aside).
"""
import dataclasses
import math
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.core import tree_leaves, tree_map

BACKENDS = ('nccl', 'gloo')

# all-reduces and all-gathers of this process since the last
# reset_collective_counts()
COLLECTIVES = {'all_reduce': 0, 'all_gather': 0}


def reset_collective_counts():
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the particle mesh: ``size`` ranks, this one
    ``rank``, their process ``group`` (None: the default group), the rank's
    ``device`` and the group's ``backend``."""
    size: int
    rank: int
    group: object
    device: torch.device
    backend: str

    def bounds(self, n):
        """(lo, hi): this rank's contiguous slice of ``n`` rows; raises
        unless the ranks split them equally."""
        if n % self.size:
            raise ValueError(f'{n} rows do not split over {self.size} ranks')
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k

    def straddles(self, groups):
        """True when ``groups`` MM groups over the whole batch do not split
        over the ranks, so that some group's rows lie on two ranks."""
        return bool(groups) and groups % self.size != 0

    def local_groups(self, groups):
        """This rank's MM groups of ``groups`` over the whole batch: G / n,
        each group within one rank's slice, when the ranks split them; the
        ``groups`` given (None: none) when they do not (``straddles``:
        then each group's moments are sums over every rank's rows,
        ``parallel.mm.mm_resample_global_groups``)."""
        if not groups or self.straddles(groups):
            return groups
        return groups // self.size


def make_mesh(device=None, group=None):
    """The ``Mesh`` of the initialised process group ``group`` (default: the
    default group) for this rank on ``device`` (default: the rank's card,
    ``rank_device``)."""
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs an initialised process group '
                           '(launch, or torch.distributed.'
                           'init_process_group)')
    rank = dist.get_rank(group)
    backend = dist.get_backend(group)
    if device is None:
        device = rank_device('cuda' if backend == 'nccl' else 'cpu', rank)
    return Mesh(dist.get_world_size(group), rank, group,
                torch.device(device), backend)


def rank_device(device, rank):
    """The device of ``rank``: the CPU for ``'cpu'``, else card
    ``rank % device_count``."""
    if torch.device(device).type == 'cpu':
        return torch.device('cpu')
    return torch.device('cuda', rank % torch.cuda.device_count())


def shard_particles(tree, mesh, axis=0):
    """This rank's contiguous slice along ``axis`` of every leaf (the
    particle or minibatch axis; JAX ``shard_particles``'s in_spec), laid
    out contiguously (a copy for ``axis`` > 0: the kernels take contiguous
    tensors)."""
    def part(x):
        lo, hi = mesh.bounds(x.shape[axis])
        return x.narrow(axis, lo, hi - lo).contiguous()

    return tree_map(part, tree)


def _reduce(t, mesh, op=dist.ReduceOp.SUM):
    if mesh.backend == 'gloo' and t.is_cuda:
        # gloo reduces in host memory: the CUDA buffer is staged through the
        # host here, explicitly, one copy each way
        host = t.cpu()
        dist.all_reduce(host, op=op, group=mesh.group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=mesh.group)
    return t


def all_reduce_(t, mesh):
    """Sum the contiguous tensor ``t`` over the ranks, in place (JAX
    ``psum``); every rank ends with the same bits. Returns ``t``."""
    COLLECTIVES['all_reduce'] += 1
    return _reduce(t, mesh)


def mean_all_reduce(tree, mesh):
    """The mean over the ranks of every tensor of ``tree`` (JAX ``pmean`` of
    a pytree), in ONE all-reduce of a flat buffer, whatever their number.
    Returns a tree of the same structure, of new tensors."""
    leaves = tree_leaves(tree)
    flat = torch.cat([t.detach().reshape(-1) for t in leaves])
    all_reduce_(flat, mesh).div_(mesh.size)
    means = {id(t): m.view(t.shape) for t, m in
             zip(leaves, flat.split([t.numel() for t in leaves]))}
    return tree_map(lambda t: means[id(t)], tree)


def all_gather(t, mesh, axis=0):
    """Every rank's ``t`` (the same shape on each), concatenated along
    ``axis`` in rank order, on every rank; no gradient."""
    COLLECTIVES['all_gather'] += 1
    t = t.detach().movedim(axis, 0).contiguous()
    host = mesh.backend == 'gloo' and t.is_cuda
    src = t.cpu() if host else t  # staged through the host, as in _reduce
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device).movedim(0, axis)


def _broadcast(t, mesh, src):
    if mesh.backend == 'gloo' and t.is_cuda:
        host = t.cpu()  # staged through the host, as in _reduce
        dist.broadcast(host, src, group=mesh.group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=mesh.group)


def replicate(tree, mesh, src=0):
    """Every leaf of ``tree`` made rank ``src``'s, in place (a broadcast per
    leaf; JAX ``replicate``). Returns ``tree``."""
    for t in tree_leaves(tree):
        with torch.no_grad():
            _broadcast(t, mesh, src)
    return tree


def broadcast_object(obj, mesh, src=0):
    """Rank ``src``'s picklable ``obj`` on every rank (the real episode, the
    results folder)."""
    box = [obj if mesh.rank == src else None]
    dist.broadcast_object_list(box, src, group=mesh.group,
                               device=None if mesh.backend == 'gloo'
                               else mesh.device)
    return box[0]


def same_on_every_rank(tree, mesh):
    """True when every leaf of ``tree`` holds the same bits on every rank
    (the elementwise max and min of the leaves' 32-bit words over the ranks
    equal this rank's), in two all-reduces."""
    leaves = [t.detach().reshape(-1) for t in tree_leaves(tree)]
    if not leaves:
        return True
    words = torch.cat([t.float() if t.dtype != torch.float32 else t
                       for t in leaves]).view(torch.int32)
    hi = _reduce(words.clone(), mesh, dist.ReduceOp.MAX)
    lo = _reduce(words.clone(), mesh, dist.ReduceOp.MIN)
    return bool(torch.equal(hi, words) and torch.equal(lo, words))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, n, backend, device, init_file, threads, inbox, outbox):
    """A rank: join the group, then run the calls ``inbox`` sends, each
    ``fn(mesh, *args)``, and put ``(rank, 'ok', result)`` or ``(rank,
    'err', traceback)`` on ``outbox``, until ``None`` comes."""
    # the ranks of one launch live on one host: keep their traffic on it
    os.environ.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(device, rank)
        if dev.type == 'cuda':
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f'file://{init_file}',
                                world_size=n, rank=rank)
        mesh = make_mesh(dev)
    except BaseException:
        outbox.put((rank, 'err', traceback.format_exc()))
        return
    try:
        while True:
            job = inbox.get()
            if job is None:
                break
            fn, args = job
            try:
                out = (rank, 'ok', fn(mesh, *args))
            except BaseException:
                out = (rank, 'err', traceback.format_exc())
            outbox.put(out)
    finally:
        dist.destroy_process_group()


class Ranks:
    """``n`` ranks spawned once, each joined to one process group of
    ``backend`` on its device (``rank_device(device, rank)``), that run the
    calls ``run`` sends them until ``close``. ``threads``: each rank's
    ``torch.set_num_threads`` (None leaves torch's default). A call that
    fails on a rank, whose rank dies, or that takes longer than ``timeout``
    seconds (None: no limit) ends every rank and raises."""

    def __init__(self, n, backend, device='cuda', threads=None,
                 timeout=600.0):
        if backend not in BACKENDS:
            raise ValueError(f'backend must be one of {BACKENDS}, not '
                             f'{backend!r}')
        if n < 1:
            raise ValueError(f'{n} ranks')
        self.n, self.backend, self.timeout = n, backend, timeout
        ctx = mp.get_context('spawn')
        self._dir = tempfile.mkdtemp(prefix='prob_mbrl_ranks_')
        init_file = os.path.join(self._dir, 'rendezvous')
        self._inboxes = [ctx.Queue() for _ in range(n)]
        self._outbox = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, n, backend, str(device), init_file, threads, self._inboxes[r],
            self._outbox)) for r in range(n)]
        for p in self._procs:
            p.start()

    @property
    def closed(self):
        return self._procs is None

    def run(self, fn, *args, timeout=None):
        """``fn(mesh, *args)`` on every rank (``fn`` and ``args``
        picklable: a module-level function); returns the ranks' results in
        rank order."""
        if self._procs is None:
            raise RuntimeError('these ranks are closed')
        for q in self._inboxes:
            q.put((fn, args))
        timeout = timeout or self.timeout
        deadline = time.monotonic() + (math.inf if timeout is None
                                       else timeout)
        results, errors = [None] * self.n, {}
        waiting = set(range(self.n))
        while waiting:
            try:
                rank, status, value = self._outbox.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in waiting
                        if self._procs[r].exitcode is not None]
                late = time.monotonic() > deadline
                if dead or late:
                    self.close(kill=True)
                    why = (f'rank(s) {dead} exited' if dead else
                           f'no result within {timeout} s')
                    raise RuntimeError(
                        f'{getattr(fn, "__name__", fn)} on {self.n} ranks: '
                        f'{why}' + ''.join(f'\nrank {r}:\n{e}'
                                           for r, e in errors.items()))
                continue
            waiting.discard(rank)
            if status == 'ok':
                results[rank] = value
            else:
                errors[rank] = value
                # the others may wait in a collective for the failed rank
                deadline = min(deadline, time.monotonic() + 10.0)
        if errors:
            self.close(kill=True)
            raise RuntimeError(
                f'{getattr(fn, "__name__", fn)} failed on rank(s) '
                f'{sorted(errors)}:' + ''.join(f'\nrank {r}:\n{e}'
                                               for r, e in errors.items()))
        return results

    def close(self, kill=False):
        """End the ranks (at once with ``kill``) and remove the rendezvous
        directory."""
        if self._procs is None:
            return
        if not kill:
            for q in self._inboxes:
                q.put(None)
            for p in self._procs:
                p.join(timeout=30)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join()
        for q in self._inboxes + [self._outbox]:
            q.close()
            if kill:
                q.cancel_join_thread()
            else:
                q.join_thread()
        self._procs = None
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)


def launch(fn, n, backend, device, *args, threads=None, timeout=600.0):
    """Spawn ``n`` ranks of ``backend`` on ``device`` (``Ranks``), run
    ``fn(mesh, *args)`` on each and end them. Returns the results in rank
    order; raises if a rank fails or the call outlasts ``timeout``
    seconds (None: no limit)."""
    with Ranks(n, backend, device, threads, timeout) as ranks:
        return ranks.run(fn, *args)
