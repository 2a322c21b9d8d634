"""Process groups, named meshes and their collectives (the counterpart of
``jax.devices()`` and of the virtual 8-device CPU mesh the JAX package's
tests run on).

``lcgp_tpu`` runs a mesh from one controller with ``shard_map``.  Here
every rank is a process that runs the same program on its own device, the
SPMD idiom of ``torchrun``: every rank constructs the same model and makes
the same calls in the same order, and each call that touches a mesh is a
collective.

- :func:`init_distributed` joins the default process group: NCCL for a card
  per rank, gloo on the CPU or, asked for explicitly, for ranks that share
  one card.  Nothing falls back: a missing card, backend or group raises
  and names what to pass.
- :class:`Mesh` is a named ``DeviceMesh`` over the first ranks of the world
  with the rank's ``torch.device`` and the collectives the parallel modules
  use along an axis: all-reduce, all-gather and broadcast from an owner,
  the first two also in a differentiable form (``grad=True``) with the
  backward rules of ``torch.distributed.nn.functional``, and
  :meth:`Mesh.enter`/:meth:`Mesh.leave` around code that differentiates
  through them.  A gloo group is a host transport,
  so under gloo a CUDA tensor is staged through the host inside the
  collective (``.cpu()``, the collective, the copy back), the same on every
  torch build, and ``Mesh.staged_bytes`` counts the bytes copied each way.
- :class:`WorkerGroup` spawns ``world_size`` local ranks once, runs a named
  function of this package on every rank and returns each rank's result;
  the tests, :func:`lcgp_tpu_torch.parallel.dryrun.dryrun_multichip` and
  ``chip_smoke.py`` use it.

A mesh may be smaller than the world (the counterpart of a JAX mesh over
some of the devices).  Every rank must construct it, because its process
groups are created collectively; a rank outside it gets a mesh whose
``member`` is False and whose collectives raise, and such a rank must make
no call on that mesh (it would otherwise wait on groups it is not in).
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import multiprocessing.connection
import os
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(backend=None, device=None, *, rank=None,
                     world_size=None, store=None,
                     timeout=DEFAULT_TIMEOUT) -> torch.device:
    """Join the default process group; returns this rank's device.

    Without ``store`` the group comes from the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
    otherwise ``rank`` and ``world_size`` go with the store.  ``device``
    None is the rank's card, ``cuda:$LOCAL_RANK``.  ``backend`` None is
    NCCL on a card and gloo on the CPU; ranks that share a card pass
    ``backend='gloo'`` with that card as ``device``.  ``timeout`` bounds
    every collective, so a rank whose peer died raises instead of hanging.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: no CUDA card for device=None; pass "
                "device='cpu' (with backend='gloo') to run on the CPU")
        device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"init_distributed: device {device} needs CUDA, "
                           "which is not available; pass device='cpu'")
    backend = _backend_for(backend, device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    kw = dict(backend=backend, timeout=timeout)
    if store is not None:
        kw.update(store=store, rank=rank, world_size=world_size)
    dist.init_process_group(**kw)
    return device


def _backend_for(backend, device: torch.device) -> str:
    """``backend``, or for None NCCL on a card and gloo on the CPU; raises
    for a backend that cannot serve ``device``."""
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f"unsupported device {device}")
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if backend not in ('nccl', 'gloo'):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == 'nccl':
        if device.type != 'cuda':
            raise ValueError("NCCL needs a card per rank; pass "
                             "backend='gloo' for CPU ranks")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL; pass "
                               "backend='gloo'")
    return backend


def resolve_device(device) -> torch.device:
    """A mesh's device: ``device``, or for None this rank's card (the one
    :func:`init_distributed` made current).  Raises without CUDA."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None is this rank's card, and CUDA is not "
                "available; pass device='cpu'")
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(device)


def _need_group(what: str):
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what}: no process group; call "
            "lcgp_tpu_torch.parallel.init_distributed() first (or run the "
            "ranks with parallel.WorkerGroup)")


class Mesh:
    """A named mesh over ranks ``0 .. prod(shape) - 1`` of the world, laid
    out row-major (the last axis varies fastest), and this rank's device.

    ``device_mesh`` is the ``torch.distributed`` ``DeviceMesh``, of type
    'cuda' under NCCL and 'cpu' under gloo (whose transport is the host);
    ``device`` is where this rank computes; ``axis_names`` and ``shape``
    (a dict) name its axes.  Every rank of the world constructs it; see the
    module docstring for a rank outside it.

    An axis that is not in ``axis_names`` has size 1 and index 0, and a
    collective along it is the identity, so code written for the 2-D meshes
    runs unchanged on a 1-D one."""

    def __init__(self, shape, axis_names, device):
        _need_group('Mesh')
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device = torch.device(device)
        need = math.prod(self.shape.values())
        world = dist.get_world_size()
        if need > world:
            raise ValueError(f"a mesh of shape {tuple(shape)} needs {need} "
                             f"ranks; the world has {world}")
        backend = dist.get_backend()
        if backend == 'nccl' and self.device.type != 'cuda':
            raise ValueError(f"an NCCL group computes on cards, not on "
                             f"{self.device}")
        # gloo moves host tensors: ranks on a card stage through the host
        self.staged = backend == 'gloo' and self.device.type == 'cuda'
        kind = 'cuda' if backend == 'nccl' else 'cpu'
        self.device_mesh = DeviceMesh(
            kind, torch.arange(need).reshape(tuple(shape)),
            mesh_dim_names=self.axis_names)
        coord = self.device_mesh.get_coordinate()
        self.member = coord is not None
        self._coord = dict(zip(self.axis_names, coord)) if self.member \
            else None
        self._groups = ({a: self.device_mesh.get_group(a)
                         for a in self.axis_names} if self.member else None)
        self.staged_bytes = 0

    def __repr__(self):
        return (f"Mesh({self.shape}, device={self.device}, "
                f"member={self.member})")

    @property
    def size_total(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        self._member('index')
        return self._coord.get(axis, 0)

    @property
    def is_first(self) -> bool:
        """True on the rank at index 0 of every axis."""
        return self.member and not any(self._coord.values())

    def _member(self, what):
        if not self.member:
            raise RuntimeError(
                f"Mesh.{what}: rank {dist.get_rank()} is not in this mesh "
                f"of shape {self.shape}; only its ranks may use it")

    # -- collectives (new tensors; the input is not modified) -------------
    def _host_run(self, t, fn, n_out: int = 1):
        """Run the in-place collective ``fn`` on a copy of t; under gloo a
        CUDA tensor goes through the host."""
        t = t.detach().contiguous()
        if self.staged:
            h = t.to('cpu', copy=True)
            out = fn(h)
            self.staged_bytes += h.nbytes * (1 + n_out)
            return out.to(self.device)
        return fn(t.clone())

    def all_reduce(self, t, axis: str, grad: bool = False):
        """Sum of t over the ranks along ``axis``."""
        if grad:
            return _AllReduce.apply(self, axis, t)
        self._member('all_reduce')
        if axis not in self.shape:
            return t.clone()
        group = self._groups[axis]

        def run(h):
            dist.all_reduce(h, group=group)
            return h
        return self._host_run(t, run)

    def all_gather(self, t, axis: str, grad: bool = False):
        """The ranks' t along ``axis``, stacked: (size, *t.shape)."""
        if grad:
            return _AllGather.apply(self, axis, t)
        self._member('all_gather')
        if axis not in self.shape:
            return t[None].clone()
        group, size = self._groups[axis], self.shape[axis]

        def run(h):
            outs = [torch.empty_like(h) for _ in range(size)]
            dist.all_gather(outs, h, group=group)
            return torch.stack(outs)
        return self._host_run(t, run, n_out=size)

    def broadcast(self, t, axis: str, owner: int):
        """The owner's t (index ``owner`` along ``axis``) on every rank of
        the axis; the other ranks pass a tensor of its shape and dtype."""
        self._member('broadcast')
        if axis not in self.shape:
            return t.clone()
        group = self._groups[axis]
        src = dist.get_global_rank(group, owner)
        mine = self._coord[axis] == owner
        t = t.detach().contiguous() if mine else t
        if not self.staged:
            out = (t.clone() if mine else
                   torch.empty(t.shape, dtype=t.dtype, device=t.device))
            dist.broadcast(out, src=src, group=group)
            return out
        # under gloo the owner sends a host copy and keeps its own tensor;
        # the others receive into host memory and copy to the card
        h = t.cpu() if mine else torch.empty(t.shape, dtype=t.dtype)
        dist.broadcast(h, src=src, group=group)
        self.staged_bytes += h.nbytes
        return t.clone() if mine else h.to(self.device)

    def from_first(self, t):
        """The mesh's first rank's t on every rank of the mesh: broadcast
        along each axis in turn from its index 0, the outer axis first."""
        for axis in self.axis_names:
            t = self.broadcast(t, axis, 0)
        return t

    def enter(self, *tensors):
        """The tensors, replicated on every rank, entering code whose
        collectives are differentiable: the backward all-reduces their
        cotangents over every axis, so each rank's partial contributions
        are summed into the gradient of the one replicated tensor.  One
        autograd node for all of them, which every rank runs even where its
        share leaves some tensor unused (its cotangent is then zero)."""
        return _Enter.apply(self, *tensors)

    def leave(self, t):
        """t, a value that every rank holds alike, leaving that code: each
        rank's copy is one share of the one result, so the backward divides
        the cotangent by the number of ranks."""
        return _Leave.apply(self, t)

    def barrier(self):
        """Wait until every rank of the mesh has arrived (one small
        all-reduce along each axis in turn)."""
        one = torch.ones(1, device=self.device)
        for axis in self.axis_names:
            self.all_reduce(one, axis)


# The differentiable all-reduce and all-gather, with
# torch.distributed.nn.functional's backward rules, and the enter/leave
# nodes around them (``mesh.py`` and ``fitc_shard.py`` differentiate
# through these).  Each is one autograd node on the tensor's device that stages
# internally, so the autograd engine runs every rank's collectives on one
# thread in the graph's order: a host copy recorded by autograd would be a
# node on the CPU queue, and the ranks could then order their collectives
# differently.

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, t):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.mesh.all_reduce(g, ctx.axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, t):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_gather(t, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.mesh, ctx.axis
        return None, None, mesh.all_reduce(g, axis)[mesh.index(axis)]


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        for axis in ctx.mesh.axis_names:
            flat = ctx.mesh.all_reduce(flat, axis)
        parts = torch.split(flat, [g.numel() for g in grads])
        return (None,) + tuple(p.view_as(g) for p, g in zip(parts, grads))


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, t):
        ctx.size = mesh.size_total
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return None, g / ctx.size


# ---------------------------------------------------------------------------
# A persistent group of local ranks
# ---------------------------------------------------------------------------

def _worker(rank, world_size, store_path, conn, device, backend, timeout_s):
    """A rank's loop: join the group, then run each (fn, args, kwargs) the
    parent sends and answer ('ok', result) or ('err', traceback); None
    ends it.  One intra-op thread a rank, so that a few ranks beside other
    test workers do not oversubscribe the CPUs."""
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world_size)
        init_distributed(backend, device, rank=rank, world_size=world_size,
                         store=store,
                         timeout=datetime.timedelta(seconds=timeout_s))
        conn.send(('ok', None))
    except Exception:
        conn.send(('err', traceback.format_exc()))
        return
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                break
            if msg is None:
                break
            fn, args, kwargs = msg
            try:
                conn.send(('ok', fn(*args, **kwargs)))
            except Exception:
                conn.send(('err', traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class WorkerGroup:
    """``world_size`` local ranks, spawned once, joined into one process
    group over a ``FileStore`` in a fresh temporary directory (no fixed
    port, so groups of several test workers run side by side).

    Every rank computes on ``device``: None is this process's card (it
    raises without CUDA; pass ``device='cpu'`` for CPU ranks).  ``backend``
    None is NCCL on a card and gloo on the CPU; NCCL takes one card per
    rank, so ranks that share a card pass ``backend='gloo'``.

    :meth:`run` calls a function of ``lcgp_tpu_torch`` on every rank with
    the same arguments and returns the ranks' results in rank order.  The
    function is sent by its import path, and a rank re-imports its module,
    so it must live in this package, not in a test module (those import
    JAX).  Arguments and results are pickled: pass NumPy arrays.

    If a rank raises, dies or does not answer within ``timeout`` seconds,
    every rank is torn down and the error is raised here; the group is
    then closed.  ``collective_timeout`` bounds each collective on the
    ranks.  Use it as a context manager, or call :meth:`close`."""

    def __init__(self, world_size: int, *, device=None, backend=None,
                 timeout: float = 600.0, collective_timeout: float = 300.0):
        self.world_size = int(world_size)
        self.timeout = timeout
        self.device = resolve_device(device)
        backend = _backend_for(backend, self.device)
        if backend == 'nccl' and self.world_size > 1:
            raise ValueError(
                f"WorkerGroup: NCCL takes one card per rank, and all "
                f"{self.world_size} ranks compute on {self.device}; pass "
                "backend='gloo' for ranks that share it")
        self._tmp = tempfile.mkdtemp(prefix='lcgp_group_')
        store_path = os.path.join(self._tmp, 'store')
        ctx = multiprocessing.get_context('spawn')
        self._conns, self._procs = [], []
        try:
            for rank in range(self.world_size):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_worker, daemon=True,
                    args=(rank, self.world_size, store_path, child,
                          str(self.device), backend, collective_timeout))
                proc.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(proc)
            self._collect(timeout)
        except BaseException:
            self.close(force=True)
            raise

    def run(self, fn, *args, timeout=None, **kwargs) -> list:
        """fn(*args, **kwargs) on every rank; the results in rank order."""
        if not self._procs:
            raise RuntimeError('WorkerGroup is closed')
        if not getattr(fn, '__module__', '').startswith('lcgp_tpu_torch'):
            raise ValueError(
                f"WorkerGroup.run: {fn!r} is not a function of "
                "lcgp_tpu_torch; a rank imports its module, so it must "
                "live in the package")
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        return self._collect(self.timeout if timeout is None else timeout)

    def _collect(self, timeout):
        results = [None] * self.world_size
        pending = set(range(self.world_size))
        waiter = multiprocessing.connection.wait
        deadline = None if timeout is None else \
            datetime.datetime.now().timestamp() + timeout
        try:
            while pending:
                left = None if deadline is None else \
                    max(0.0, deadline - datetime.datetime.now().timestamp())
                conns = {self._conns[r]: r for r in pending}
                sentinels = {self._procs[r].sentinel: r for r in pending}
                ready = waiter(list(conns) + list(sentinels), timeout=left)
                if not ready:
                    raise TimeoutError(
                        f"WorkerGroup: ranks {sorted(pending)} did not "
                        f"answer within {timeout} s")
                for obj in ready:
                    if obj in conns:
                        r = conns[obj]
                        status, value = obj.recv()
                        if status == 'err':
                            raise RuntimeError(f"rank {r} raised:\n{value}")
                        results[r] = value
                        pending.discard(r)
                for obj in ready:
                    r = sentinels.get(obj)
                    if r is not None and r in pending and \
                            not self._conns[r].poll():
                        raise RuntimeError(
                            f"rank {r} exited with code "
                            f"{self._procs[r].exitcode}")
        except BaseException:
            # the other ranks may be waiting in a collective: end them now
            self.close(force=True)
            raise
        return results

    def close(self, force: bool = False):
        """End every rank and remove the store: each is asked to leave
        and given 10 s, then terminated; ``force`` terminates at once."""
        if not force:
            for conn, proc in zip(self._conns, self._procs):
                if proc.is_alive():
                    try:
                        conn.send(None)
                    except (BrokenPipeError, OSError):
                        pass
            for proc in self._procs:
                proc.join(timeout=10)
        for proc in self._procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5)
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
