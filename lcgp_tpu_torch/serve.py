"""Prediction serving: a warm, fixed-shape predict path behind a minimal
HTTP JSON API (counterpart of the JAX package's ``serve.py``).

Load a saved model once, build the predict step at a fixed batch shape
(requests of any size are chunked and padded to it, so the server never
rebuilds per request), and serve.  On CUDA the step, standardize -> latent
core -> recombine, is a CUDA graph captured once per static signature and
batch shape over a static input buffer and the server's own state tensors:
a warm dispatch is one copy in, one graph replay (the Gram kernel K1, K3 or
K4 of the cross-covariance and the cuBLAS calls inside it) and one copy out.
On the CPU the same step runs eagerly.

Concurrency: a single dispatcher thread owns the predict graph and
*microbatches*: concurrent requests are coalesced row-wise into one padded
fixed-shape dispatch and the results fanned back out, so k concurrent small
requests cost about one device call instead of k serialized ones.

A mesh model (``LCGP.set_mesh`` or ``fit(mesh=...)``, ``parallel``) is
served by every rank of its mesh: each constructs ``PredictServer`` with its
own model (the aux is a collective), the mesh's first rank serves as above,
and every other rank calls :meth:`PredictServer.follow`, which runs the
commands the first rank's dispatcher broadcasts (a header, then the padded
batch or a path) until the first rank's ``shutdown()``.  An exact mesh
model's step is a collective (``parallel.nshard.predict_nsharded_core``):
it runs eagerly, with no graph, and every dispatch is broadcast.  A FITC
mesh model predicts from its replicated aux with no collective, keeps the
graph, and broadcasts nothing per request.  A reload, which builds the new
aux, is a collective on either: it runs on the dispatcher thread between
two dispatches, on every rank.  While a mesh server runs, its mesh belongs
to it: the ranks make no other call on the mesh until ``shutdown()``.

API:
  GET  /healthz            -> {"status": "ok"}
  GET  /info               -> model/config summary
  POST /predict {"x": [[...], ...]}
       -> {"ypred": [[p x n0]], "ypredvar": ..., "yconfvar": ...}
  POST /predict {"x": ..., "fullcov": true}
       -> adds "yfullcov" (n0 x p x p); submethod='full' models only
  POST /reload  {"path": "new_model.npz"}
       -> hot-swap the served model with zero downtime; when the new
          model's config and state shapes match (the periodic-refit
          pattern) the captured graph is reused: the new state is copied
          into the tensors it reads, with no new capture.  Replies with
          {"reused_executable": ..., "warmup_secs": ..., ...info}.
          Disabled (403) unless the server was given ``reload_dir``.  On a
          mesh every rank loads the path and attaches the served mesh.

Usage:
  python -m lcgp_tpu_torch.serve model.npz --port 8080 --batch-size 256
or programmatically:
  server = PredictServer('model.npz'); server.serve(port=8080)
"""
from __future__ import annotations

import argparse
import json
import os
import queue as queue_mod
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .utils.profiling import (finished, new_id, record_compile, recording,
                              stamp)

_F64 = torch.float64


class _Chunk:
    """One <=batch_size slice of a request, awaiting a microbatch slot.
    While spans are recorded (``utils.profiling``), ``owner`` is its
    request's (span id, sender thread), ``t_put`` when it entered the queue
    and ``t_set`` when its result was handed over (``time.time_ns()``)."""
    __slots__ = ('x0', 'event', 'result', 'error', 'owner', 't_put', 't_set')

    def __init__(self, x0):
        self.x0 = x0
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.owner = self.t_put = self.t_set = None


def _request_spans(record):
    """A request's stamps as spans: ``lcgp.serve.request`` (``predict``'s
    entry to its return) and ``lcgp.serve.wake`` (its last chunk's result
    handed over to the return)."""
    (rid, tid), t0, t1, rows, t_set = record
    yield finished('lcgp.serve.request', t0, t1, tid, request=rid,
                   span_id=rid, rows=rows)
    if t_set is not None:
        yield finished('lcgp.serve.wake', t_set, t1, tid, parent=rid,
                       request=rid)


def _dispatch_spans(record):
    """A dispatch's stamps as spans: ``lcgp.serve.dispatch`` (its group
    taken to the last result handed over), its children ``.replay`` (copy
    in and graph launch; none without a graph) and ``.wait`` (the device's
    work and the copy out), and each chunk's ``lcgp.serve.queue_wait`` (its
    entry into the queue to the dispatch's start) on its sender."""
    t0, t1, tid, rows, (r0, r1, w1), chunks = record
    d = finished('lcgp.serve.dispatch', t0, t1, tid, rows=rows,
                 chunks=len(chunks))
    yield d
    if r0 is not None:
        yield finished('lcgp.serve.replay', r0, r1, tid, parent=d.id)
    yield finished('lcgp.serve.wait', r1, w1, tid, parent=d.id)
    for owner, t_put in chunks:
        if t_put is not None:
            yield finished('lcgp.serve.queue_wait', t_put, t0, owner[1],
                           parent=owner[0], request=owner[0],
                           dispatch=d.id)


class _Swap:
    """Work run by the dispatcher thread between two dispatches: a
    reload's swap of the served model, or on a mesh any command."""
    __slots__ = ('apply', 'event', 'error', 'result')

    def __init__(self, apply):
        self.apply = apply
        self.event = threading.Event()
        self.error = None
        self.result = None


def _is_path(obj) -> bool:
    return isinstance(obj, (str, bytes)) or hasattr(obj, '__fspath__')


# The mesh protocol: the commands the first rank's dispatcher broadcasts to
# the followers, each a header (command, payload length) and its payload
_NOOP, _STEP, _FULLCOV, _LOAD, _MODEL, _STOP = range(6)
# an idle dispatcher sends _NOOP this often, so that no follower's wait
# reaches the process group's collective timeout
_HEARTBEAT_S = 5.0


def _map(fn, tree):
    """``fn`` applied to every tensor of a tree of dicts and NamedTuples,
    keeping the tree's structure; other leaves (a string) are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_map(fn, v) for v in tree))
    return tree


def _leaves(tree) -> list:
    """The tensors of a tree, dict entries in key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return []


def _structure(tree):
    """A tree's structure without its tensors, comparable with ``==``."""
    if isinstance(tree, torch.Tensor):
        return None
    if isinstance(tree, dict):
        return tuple((k, _structure(tree[k])) for k in sorted(tree))
    if isinstance(tree, tuple):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return tree


class _Fused:
    """The fused predict step at the server's fixed batch shape, bound to
    the state tensors it reads (the counterpart of the jitted executable).

    ``step(state, x0)`` is the step as a function (standardize -> latent
    core -> recombine, returning a tuple of tensors).  On CUDA it is
    captured once into a CUDA graph over a static (batch_size, d) input
    buffer and ``state``; a call ``fn(x0)`` copies the padded batch in,
    replays the graph and copies the outputs to the host before it returns,
    so the next replay may overwrite them.  A capture that fails raises: there is no
    eager fallback on CUDA.  On the CPU, and for a step with collectives
    (``graph=False``: a graph cannot hold them), the step runs eagerly.
    ``calls`` counts the calls, one per dispatch.  ``stamps``: None, or
    while the dispatcher records spans a list that the next call extends
    with ``time.time_ns()`` at the copy in (None with no graph), after the
    graph's launch and after the outputs' copy to the host."""

    def __init__(self, step, state, batch_size: int, d: int, what: str,
                 graph: bool = True):
        self.step, self.state = step, state
        self.device = state['x_min'].device
        self.calls = 0
        self.stamps = None
        self.graph = None
        if self.device.type == 'cuda' and graph:
            self._capture(batch_size, d, what)

    def _capture(self, batch_size: int, d: int, what: str):
        from .ops._build import build

        build()   # the nvcc build and the dlopen stay outside the capture
        self.stream = torch.cuda.Stream(self.device)
        self.x0 = torch.full((batch_size, d), 0.5, dtype=_F64,
                             device=self.device)
        t0 = time.perf_counter()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.stream(self.stream):
            # one eager call first, on the capture's stream: each kernel's
            # first-launch set-up and the library handles stay outside it
            self.step(self.state, self.x0)
            self.stream.synchronize()
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode='thread_local'):
                outs = self.step(self.state, self.x0)
                # one flat output: one copy to the host per dispatch
                self.flat = torch.cat([o.reshape(-1) for o in outs])
        self.shapes = [tuple(o.shape) for o in outs]
        self.graph = graph
        record_compile(f'CUDA graph capture of {what} at batch '
                       f'{batch_size}', time.perf_counter() - t0)

    def eager(self, x0):
        """The step run eagerly on the bound state (no graph); the outputs
        as NumPy arrays."""
        with torch.no_grad():
            outs = self.step(self.state, torch.as_tensor(
                x0, dtype=_F64, device=self.device))
        return [o.cpu().numpy() for o in outs]

    def __call__(self, x0):
        """The outputs at the (batch_size, d) float64 batch x0 over the
        bound state, as NumPy arrays on the host."""
        self.calls += 1
        stamps = self.stamps
        if self.graph is None:
            if stamps is not None:
                stamps += (None, time.time_ns())
            outs = self.eager(x0)
        else:
            with torch.cuda.stream(self.stream):
                if stamps is not None:
                    stamps.append(time.time_ns())
                self.x0.copy_(torch.from_numpy(x0))
                self.graph.replay()
                if stamps is not None:
                    stamps.append(time.time_ns())
                flat = self.flat.cpu().numpy()    # waits for the replay
            outs, ofs = [], 0
            for shape in self.shapes:
                size = int(np.prod(shape))
                outs.append(flat[ofs:ofs + size].reshape(shape))
                ofs += size
        if stamps is not None:
            stamps.append(time.time_ns())
        return outs

    def load_state(self, new):
        """Copy ``new`` (the bound state's structure, shapes and dtypes)
        into the bound state tensors, and wait for the copies."""
        if self.graph is None:
            for dst, src in zip(_leaves(self.state), _leaves(new)):
                dst.copy_(src)
            return
        with torch.cuda.stream(self.stream):
            for dst, src in zip(_leaves(self.state), _leaves(new)):
                dst.copy_(src)
            self.stream.synchronize()


class PredictServer:
    def __init__(self, model_or_path, batch_size: int = 256,
                 warmup: bool = True, reload_dir=None, device='cuda'):
        """``reload_dir``: directory HTTP ``POST /reload`` may load model
        files from.  ``None`` (default) disables the HTTP reload endpoint
        entirely — an unauthenticated endpoint that loads any
        client-named filesystem path is an arbitrary-file-read primitive.
        The in-process :meth:`reload` method is always available.

        ``device``: where a model loaded from a path lives (``LCGP.load``);
        a model object is served on its own device.  The server predicts
        from its own copy of the model's state, so a later ``fit`` on the
        model object changes nothing served until :meth:`reload`.  On
        CUDA the predict graph is captured here.

        A mesh model is served by every rank of its mesh, each passing its
        own model (a collective: the aux is built here); the mesh's first
        rank serves, and warms up there, the others call :meth:`follow`."""
        from .models.lcgp import LCGP
        if _is_path(model_or_path):
            self.model = LCGP.load(model_or_path, device=device)
        else:
            self.model = model_or_path
        self.device = self.model.device
        self._mesh = self.model._n_mesh
        self._leader = self._mesh is None or self._mesh.is_first
        self.reload_dir = (None if reload_dir is None
                           else os.path.realpath(os.fspath(reload_dir)))
        self.batch_size = int(batch_size)
        self._httpd = None
        self._reload_lock = threading.Lock()
        self._reload_count = 0
        self._sig = self._static_sig(self.model)
        self._state = self._extract_state(self.model)
        self._fn = self._build_fused(self.model, self._state)
        self._live = self._fn      # the step the dispatcher reads
        self._fn_fullcov = None                  # built on first use
        self._fullcov_lock = threading.Lock()
        # held while state tensors are written in place (a same-shape
        # reload) and while a fullcov request reads them
        self._state_lock = threading.Lock()
        # a request's chunks, and a reload's swap, enter the queue under
        # this lock: no swap falls between two chunks of one request
        self._enqueue_lock = threading.Lock()
        self._closed = False
        self._failed = None      # what killed the dispatcher, if it died
        self._queue: queue_mod.Queue = queue_mod.Queue()
        self._dispatcher = None
        if self._leader:
            self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                                daemon=True)
            self._dispatcher.start()
            if warmup:
                self.warmup()

    @staticmethod
    def _static_sig(model):
        """Trace-relevant model config: two models with equal signatures
        share one fused function (and, with equal state shapes, one
        captured graph).  ``_n_mesh`` is the model's n-mesh (None off a
        mesh): mesh models share a step only on the same mesh."""
        return (model.submethod, model.kernel, str(model._compute_dtype),
                float(model._jitter), model.q_chunk, model._z is not None,
                model._n_mesh, bool(model.rep_standardize_ybar))

    @staticmethod
    def _extract_state(model):
        """Everything the fused step consumes, as tensors the server owns:
        clones of the model's, the hot-reloadable part.  A refit (or a
        refit on same-shape new data) changes only these values, so a
        reload copies them into the captured graph's tensors and captures
        nothing.  Clones, because a graph binds addresses: a reload's
        in-place write must not reach the user's model, and a later ``fit``
        on the model must not reach the server (snapshot semantics)."""
        return _map(lambda t: t.detach().clone(
            memory_format=torch.contiguous_format),
            PredictServer._model_state(model))

    @staticmethod
    def _model_state(model):
        """The tensors of ``_extract_state``, still the model's own."""
        st = dict(free=model._free, data=model._data,
                  aux=model._ensure_aux(),
                  x_min=model.x_min, x_max=model.x_max)
        if model._z is not None:
            st['z'] = model._z
        if model.submethod == 'rep':
            if model.rep_standardize_ybar:
                st['mean'], st['std'] = model.ybar_mean, model.ybar_std
            else:
                st['mean'] = torch.zeros_like(model.ybar_mean)
                st['std'] = torch.ones_like(model.ybar_std)
        else:
            st['mean'], st['std'] = model.ymean, model.ystd
        return _map(torch.Tensor.detach, st)

    @staticmethod
    def _step_collective(model) -> bool:
        """Whether the model's predict step runs collectives: an exact
        model on a mesh (a FITC mesh model's aux is replicated)."""
        return model._n_mesh is not None and model._z is None

    def _latent_core(self, model):
        """The pure latent-predict core for the model's static config:
        state-parametric counterpart of ``LCGP._latent_predict``.  FITC's
        variances are clamped at 0 without the model's clamp statistics.
        An exact mesh model's core is a collective."""
        from .models import predict as pred

        cdtype, jitter = model._compute_dtype, model._jitter
        kernel, q_chunk = model.kernel, model.q_chunk
        if model._z is not None:
            from .models import sparse

            def core(st, x0s):
                ghat, gvar = sparse.predict_fitc_core(
                    st['free'], st['data'], st['aux'], st['z'], x0s,
                    compute_dtype=cdtype, kernel=kernel)
                return ghat, torch.clamp_min(gvar, 0.0)
            return core
        if model._n_mesh is not None:
            from .parallel import nshard
            mesh = model._n_mesh

            def core(st, x0s):
                return nshard.predict_nsharded_core(
                    st['free'], st['data'], st['aux'], x0s, mesh,
                    compute_dtype=cdtype, jitter=jitter, kernel=kernel)
            return core
        fn = (pred.predict_rep_core if model.submethod == 'rep'
              else pred.predict_full_core)

        def core(st, x0s):
            return fn(st['free'], st['data'], st['aux'], x0s,
                      compute_dtype=cdtype, jitter=jitter, kernel=kernel,
                      q_chunk=q_chunk)
        return core

    def _build_fused(self, model, state):
        """One end-to-end predict step at the fixed batch shape over
        ``state``: a CUDA graph on CUDA (captured here), the eager step on
        the CPU.

        Driving model.predict per request costs several separate launches
        and host round trips (standardize, core, recombine, pad/slice);
        the graph makes a warm request one replay, with padding and
        unpadding done host-side in NumPy.  The model state enters as the
        ``state`` tensors the graph reads, not as constants: ``reload``
        writes a same-shape state into them, so a parameter-only model
        update costs no capture and no downtime."""
        from .models import predict as pred

        latent = self._latent_core(model)
        rec = (pred.recombine_rep if model.submethod == 'rep'
               else pred.recombine_full)

        def fused(state, x0):
            x0s = (x0 - state['x_min']) / (state['x_max'] - state['x_min'])
            ghat, gvar = latent(state, x0s)
            return rec(state['free'], state['data'], ghat, gvar,
                       state['mean'], state['std'])

        return _Fused(fused, state, self.batch_size, int(model.d),
                      f'the predict step {self._static_sig(model)}',
                      graph=not self._step_collective(model))

    def reload(self, model_or_path):
        """Hot-swap the served model with zero downtime.

        Loads the new model (path or LCGP instance; a path loads onto the
        served model's device), warms its predict OFF the serving path,
        then has the dispatcher swap it in between two dispatches.  Every
        request is answered wholly by the old model or wholly by the new
        one; requests queued after the swap see the new one.

        When the new model's static config matches (submethod, kernel,
        precision, q_chunk, FITC/mesh mode) and its state tensors' shapes,
        dtypes and devices equal the old state's (the common
        refit-on-new-data case), the captured graph is reused outright:
        the new model's state is copied straight into the tensors it reads.
        Otherwise a new graph is captured over a clone of the new state.  Returns a dict:
        ``{'reused_executable': bool, 'warmup_secs': float, ...info}``.

        On a mesh server the reload is a collective, run on the dispatcher
        thread (requests wait for it): a path is broadcast and every rank
        loads it and attaches the served mesh; a model is this rank's, and
        each follower takes its own from the ``reload`` callable it gave
        :meth:`follow`.  A new model must be on the served mesh.
        """
        from .models.lcgp import LCGP

        self._lead('reload')
        path = None
        if _is_path(model_or_path):
            path = os.fspath(model_or_path)
            path = path.decode() if isinstance(path, bytes) else path
            new_model = LCGP.load(path, device=self.device)
        else:
            new_model = model_or_path
        if int(new_model.d) != int(self.model.d):
            raise ValueError(
                f'reload d mismatch: serving d={int(self.model.d)}, new '
                f'model d={int(new_model.d)} — clients post (n0, d) inputs')
        if self._mesh is not None:
            return self._reload_mesh(new_model, path)
        self._check_mesh_of(new_model)

        with self._reload_lock:
            new_sig = self._static_sig(new_model)
            # the new model's own tensors: a same-shape swap copies them
            # into the graph's state, so only a new capture needs a clone
            new_state = self._model_state(new_model)
            same_shape = self._same_shape(new_sig, new_state)
            # Warm (capture if needed) off the serving path: the dispatcher
            # keeps answering from the old state until the swap below.
            x0 = np.full((self.batch_size, int(new_model.d)), 0.5)
            t0 = time.time()
            if same_shape:
                fn = self._fn
                with torch.no_grad():
                    outs = fn.step(new_state, torch.as_tensor(
                        x0, dtype=_F64, device=fn.device))
                    outs[0].cpu()           # waits for the step
            else:
                new_state = self._extract_state(new_model)
                fn = self._build_fused(new_model, new_state)
                fn(x0)
            warm = time.time() - t0
            self._run_on_dispatcher(lambda: self._swap_in(
                new_model, new_sig, fn, new_state if same_shape else None))
        return dict(reused_executable=bool(same_shape),
                    warmup_secs=round(warm, 3), **self.info())

    def _check_mesh_of(self, new_model):
        if new_model._n_mesh is not self._mesh:
            raise ValueError(
                'reload: the new model must be on the served mesh '
                f'({self._mesh}), not on {new_model._n_mesh}')

    def _same_shape(self, new_sig, new_state) -> bool:
        """Whether a model of signature ``new_sig`` and state ``new_state``
        can reuse the served step: its state copied into the step's."""
        return (new_sig == self._sig and
                _structure(new_state) == _structure(self._state)
                and all(a.shape == b.shape and a.dtype == b.dtype
                        and a.device == b.device
                        for a, b in zip(_leaves(new_state),
                                        _leaves(self._state))))

    def _swap_in(self, new_model, new_sig, fn, new_state=None):
        """Serve ``new_model`` through ``fn``, its state first copied into
        the served step's when ``new_state`` is given (a same-shape swap).
        Runs between two dispatches."""
        if new_state is not None:
            with self._state_lock:
                fn.load_state(new_state)
        else:
            self._fn_fullcov = None  # rebuilt on next fullcov request
        self.model, self._state, self._fn, self._sig = \
            new_model, fn.state, fn, new_sig
        self._live = fn
        self._reload_count += 1

    def _install(self, new_model) -> bool:
        """A mesh server's swap, run alike by every rank at one command:
        the new state (its aux, a collective), the served step reused on a
        same-shape state or built anew, the swap.  Returns whether the
        step was reused."""
        new_sig = self._static_sig(new_model)
        new_state = self._model_state(new_model)
        same_shape = self._same_shape(new_sig, new_state)
        if same_shape:
            fn = self._fn
        else:
            new_state = self._extract_state(new_model)
            fn = self._build_fused(new_model, new_state)
        self._swap_in(new_model, new_sig, fn,
                      new_state if same_shape else None)
        return same_shape

    def _reload_mesh(self, new_model, path):
        """The first rank's half of a mesh reload (see :meth:`reload`)."""
        if path is None:
            self._check_mesh_of(new_model)
        with self._reload_lock:
            t0 = time.time()

            def apply():
                if path is None:
                    self._command(_MODEL)
                else:
                    self._command(_LOAD, path.encode())
                    new_model.set_mesh(self._mesh)
                return self._install(new_model)
            same_shape = self._run_on_dispatcher(apply, inline=False)
            warm = time.time() - t0
        return dict(reused_executable=bool(same_shape),
                    warmup_secs=round(warm, 3), **self.info())

    def _run_on_dispatcher(self, apply, inline: bool = True):
        """Run ``apply`` on the dispatcher thread between two dispatches
        and return its result (inline once the server is shut down, unless
        ``inline`` is False: then it raises); re-raise its error."""
        swap = _Swap(apply)
        with self._enqueue_lock:
            if self._failed is not None:
                raise self._dead()
            if self._closed:
                if not inline:
                    raise RuntimeError('the server is shut down')
                return apply()
            self._queue.put(swap)
        swap.event.wait()
        if swap.error is not None:
            raise swap.error
        return swap.result

    def warmup(self):
        """Run one full fixed-batch dispatch before the first request."""
        d = int(self.model.d)
        x0 = np.full((self.batch_size, d), 0.5)
        t0 = time.time()
        self.predict(x0)
        return time.time() - t0

    def _lead(self, what: str):
        if not self._leader:
            raise RuntimeError(
                f'PredictServer.{what}: this rank follows the first rank of '
                f'the mesh; call follow() here and {what} on the first rank')

    def _checked(self, x0):
        """A request as a float64 (n0, d) array, validated before anything
        is dispatched or broadcast."""
        x0 = np.atleast_2d(np.asarray(x0, dtype=np.float64))
        if x0.ndim != 2 or x0.shape[1] != int(self.model.d):
            raise ValueError(
                f'expected (n0, {int(self.model.d)}) inputs, got {x0.shape}')
        return x0

    def predict(self, x0):
        """Thread-safe predict through the microbatching dispatcher.

        The request is split into <=batch_size chunks; each chunk is
        coalesced with whatever other requests are concurrently pending
        into one padded fixed-shape dispatch, and the rows are fanned back
        out.  Values are identical to ``model.predict``, as NumPy arrays.
        """
        self._lead('predict')
        x0 = self._checked(x0)
        bs = self.batch_size
        on = recording()
        if on:
            t0, owner = time.time_ns(), (new_id(), threading.get_native_id())
        chunks = [_Chunk(x0[s:s + bs]) for s in range(0, x0.shape[0], bs)]
        with self._enqueue_lock:
            if self._failed is not None:
                raise self._dead()
            if self._closed:
                raise RuntimeError('the server is shut down')
            for c in chunks:
                if on:
                    c.owner, c.t_put = owner, time.time_ns()
                self._queue.put(c)
        for c in chunks:
            c.event.wait()
            if c.error is not None:
                raise c.error
        out = tuple(np.concatenate([c.result[i] for c in chunks], axis=1)
                    for i in range(3))
        if on:
            stamp(_request_spans, (owner, t0, time.time_ns(), x0.shape[0],
                                   chunks[-1].t_set))
        return out

    def predict_fullcov(self, x0):
        """Predict with the (n0, p, p) full predictive covariance.

        Full-submethod models only (the rep path's fullcov slot is None by
        the reference contract, lcgp.py:928-929).  Fullcov payloads are
        O(n0 p^2): requests run serialized through their own fused step
        (a second graph on CUDA, captured on first use over the same state
        tensors) rather than the row-microbatcher.  A request reads one
        model's state throughout.  An exact mesh model's fullcov step is a
        collective: it runs on the dispatcher thread, each chunk broadcast.
        """
        self._lead('predict_fullcov')
        x0 = self._checked(x0)
        with self._fullcov_lock:
            if self._step_collective(self.model):
                outs = self._run_on_dispatcher(
                    lambda: self._fullcov_chunks(x0, self._fullcov_fn(),
                                                 announce=True),
                    inline=False)
            else:
                with self._reload_lock:     # pair fn_fullcov with the model
                    fn = self._fullcov_fn()
                with self._state_lock:
                    outs = self._fullcov_chunks(x0, fn)
        return tuple(np.concatenate([o[i] for o in outs],
                                    axis=1 if i < 3 else 0)
                     for i in range(4))

    def _fullcov_fn(self):
        """The served model's fullcov step, built on first use.  Raises
        for a rep model: a concurrent full->rep reload after an unlocked
        check would otherwise hand a rep model to the fullcov build."""
        if self.model.submethod != 'full':
            raise ValueError('full predictive covariance is only available '
                             "for submethod='full' models")
        if self._fn_fullcov is None:
            self._fn_fullcov = self._build_fused_fullcov(self.model,
                                                         self._state)
        return self._fn_fullcov

    def _fullcov_chunks(self, x0, fn, announce: bool = False):
        """The fullcov step ``fn`` over x0's padded chunks; with
        ``announce`` each chunk is broadcast to the followers first."""
        bs = self.batch_size
        outs = []
        for s in range(0, x0.shape[0], bs):
            blk = x0[s:s + bs]
            k = blk.shape[0]
            if k < bs:
                blk = np.concatenate([blk, np.repeat(blk[-1:], bs - k,
                                                     axis=0)])
            if announce:
                self._command(_FULLCOV, blk)
            res = fn(blk)
            outs.append((res[0][:, :k], res[1][:, :k], res[2][:, :k],
                         res[3][:k]))
        return outs

    def _build_fused_fullcov(self, model, state):
        from .models import predict as pred

        latent = self._latent_core(model)

        def fused(state, x0):
            x0s = (x0 - state['x_min']) / (state['x_max'] - state['x_min'])
            ghat, gvar = latent(state, x0s)
            yp, ypv, ycv = pred.recombine_full(state['free'], state['data'],
                                               ghat, gvar,
                                               state['mean'], state['std'])
            cov = pred.fullcov_full(state['free'], state['data'], gvar,
                                    state['std'])
            return yp, ypv, ycv, cov

        return _Fused(fused, state, self.batch_size, int(model.d),
                      f'the fullcov step {self._static_sig(model)}',
                      graph=not self._step_collective(model))

    # -- the mesh protocol ---------------------------------------------
    def _command(self, op: int, payload=None):
        """First rank, on a mesh: broadcast one command to the followers,
        its header (op, payload length) and its payload (a padded batch or
        a path's bytes).  Off a mesh, nothing."""
        mesh = self._mesh
        if mesh is None:
            return
        if isinstance(payload, bytes):
            payload = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        elif payload is not None:
            payload = torch.as_tensor(payload, dtype=_F64)
        size = 0 if payload is None else payload.numel()
        mesh.from_first(torch.tensor([op, size], dtype=torch.int64,
                                     device=mesh.device))
        if payload is not None:
            mesh.from_first(payload.to(mesh.device))

    def _receive(self):
        """A follower's half of :meth:`_command`: (op, payload tensor on
        the mesh's device or None)."""
        mesh = self._mesh
        op, size = mesh.from_first(torch.zeros(
            2, dtype=torch.int64, device=mesh.device)).tolist()
        if op in (_STEP, _FULLCOV):
            shape, dtype = (self.batch_size, int(self.model.d)), _F64
        elif op == _LOAD:
            shape, dtype = (size,), torch.uint8
        else:
            return op, None
        return op, mesh.from_first(torch.empty(shape, dtype=dtype,
                                               device=mesh.device))

    def follow(self, reload=None):
        """On a mesh's other ranks: run the first rank's commands until its
        :meth:`shutdown`, then return.  Each dispatch of an exact mesh
        model, each fullcov chunk and each reload runs here as it runs on
        the first rank.  ``reload`` is a callable returning this rank's
        model for each in-process ``reload(model)`` the first rank makes
        (every rank's program builds its own).  A step that fails here
        fails on the first rank too, which answers its clients with the
        error; the loop goes on."""
        if self._mesh is None or self._leader:
            raise RuntimeError('follow() runs on the ranks of a served mesh '
                               'other than its first; the first rank serves')
        from .models.lcgp import LCGP
        while True:
            op, payload = self._receive()
            if op == _STOP:
                self._closed = True
                return
            try:
                if op == _STEP:
                    self._live(payload)
                elif op == _FULLCOV:
                    self._fullcov_fn()(payload)
                elif op == _LOAD:
                    model = LCGP.load(bytes(payload.cpu().numpy()).decode(),
                                      device=self.device)
                    model.set_mesh(self._mesh)
                    self._install(model)
                elif op == _MODEL:
                    if reload is None:
                        raise RuntimeError(
                            'the first rank reloaded a model: pass '
                            'follow(reload=...) a callable returning this '
                            "rank's")
                    model = reload()
                    self._check_mesh_of(model)
                    self._install(model)
            except Exception:  # noqa: BLE001 — the first rank reports it
                if op == _MODEL and reload is None:
                    raise
                traceback.print_exc()

    def _dispatch_loop(self):
        """Dispatcher thread: sole owner of the predict graph (see
        :meth:`_dispatch_forever`).  Should it die, every queued and later
        request or reload fails with its error instead of waiting."""
        try:
            self._dispatch_forever()
        except BaseException as e:
            with self._enqueue_lock:
                self._failed = e
                while True:
                    try:
                        item = self._queue.get_nowait()
                    except queue_mod.Empty:
                        break
                    if item is not None:
                        item.error = self._dead()
                        item.event.set()
            raise

    def _dead(self) -> RuntimeError:
        """A new error for one call on a server whose dispatcher died,
        caused by what killed it (a new one each time: a raised error keeps
        every frame it passes through)."""
        err = RuntimeError(
            f"the server's dispatcher thread died: {self._failed!r}")
        err.__cause__ = self._failed
        return err

    def _dispatch_forever(self):
        """Blocks for one pending chunk, then greedily drains more pending
        chunks while their rows still fit the fixed batch shape —
        concurrent clients share a single padded dispatch.  A reload's swap
        runs here too, between two dispatches.  On a mesh it is the only
        thread that issues the server's collectives: it broadcasts each
        command (a collective step's batch, a reload, the stop) before
        running it, and a heartbeat when idle.
        """
        if self._fn.device.type == 'cuda':
            # the state's device, always indexed (the model's may be 'cuda')
            torch.cuda.set_device(self._fn.device)
        bs = self.batch_size
        idle = None if self._mesh is None else _HEARTBEAT_S
        tid = threading.get_native_id()
        while True:
            try:
                first = self._queue.get(timeout=idle)
            except queue_mod.Empty:
                try:
                    self._command(_NOOP)
                except Exception:  # noqa: BLE001 — the next command fails
                    pass
                continue
            if first is None:        # shutdown sentinel
                self._command(_STOP)
                return
            if isinstance(first, _Swap):
                try:
                    first.result = first.apply()
                except Exception as e:   # noqa: BLE001 — reload re-raises
                    first.error = e
                first.event.set()
                continue
            group = [first]
            rows = first.x0.shape[0]
            while rows < bs:
                try:
                    nxt = self._queue.queue[0]   # peek
                except IndexError:
                    break
                if not isinstance(nxt, _Chunk) or \
                        rows + nxt.x0.shape[0] > bs:
                    break
                group.append(self._queue.get_nowait())
                rows += group[-1].x0.shape[0]
            # while recording, the clock readings of the dispatch's spans
            t0 = time.time_ns() if recording() else None
            stamps = self._fn.stamps = None if t0 is None else []
            try:
                batch = np.concatenate([c.x0 for c in group])
                pad = bs - batch.shape[0]
                if pad:
                    batch = np.concatenate(
                        [batch, np.repeat(batch[-1:], pad, axis=0)])
                if self._step_collective(self.model):
                    self._command(_STEP, batch)
                res = self._live(batch)
                ofs = 0
                for c in group:
                    k = c.x0.shape[0]
                    c.result = [o[:, ofs:ofs + k] for o in res]
                    ofs += k
                    if stamps is not None:
                        c.t_set = time.time_ns()
                    c.event.set()
            except Exception as e:   # noqa: BLE001 — fan the error out
                for c in group:
                    c.error = e
                    c.event.set()
            else:
                if stamps is not None:
                    stamp(_dispatch_spans, (
                        t0, time.time_ns(), tid, rows, stamps,
                        [(c.owner, c.t_put) for c in group]))

    def info(self):
        m = self.model
        return dict(method=m.method, submethod=m.submethod, n=int(m.n),
                    d=int(m.d), p=int(m.p), q=int(m.q),
                    precision=m.precision, kernel=m.kernel,
                    inducing=None if m._z is None else int(m._z.shape[0]),
                    mesh=None if self._mesh is None else dict(
                        self._mesh.shape),
                    batch_size=self.batch_size,
                    reload_count=self._reload_count)

    # -- HTTP ----------------------------------------------------------
    def _make_handler(server):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == '/healthz':
                    self._reply(200, {'status': 'ok'})
                elif self.path == '/info':
                    self._reply(200, server.info())
                else:
                    self._reply(404, {'error': 'not found'})

            def do_POST(self):
                if self.path == '/reload':
                    if server.reload_dir is None:
                        self._reply(403, {'error': 'HTTP reload disabled; '
                                          'start the server with reload_dir= '
                                          'to enable it'})
                        return
                    try:
                        length = int(self.headers.get('Content-Length', 0))
                        req = json.loads(self.rfile.read(length) or b'{}')
                        path = os.path.realpath(
                            os.path.join(server.reload_dir, str(req['path'])))
                        if os.path.commonpath(
                                [path, server.reload_dir]) != server.reload_dir:
                            self._reply(403, {'error': 'reload path escapes '
                                              'the configured reload_dir'})
                            return
                        self._reply(200, server.reload(path))
                    except Exception as e:  # noqa: BLE001 — a corrupt model
                        # file (BadZipFile, OSError, ...) must return a JSON
                        # error, not abort the connection
                        self._reply(400, {'error': f'{type(e).__name__}: {e}'})
                    return
                if self.path != '/predict':
                    self._reply(404, {'error': 'not found'})
                    return
                try:
                    length = int(self.headers.get('Content-Length', 0))
                    req = json.loads(self.rfile.read(length) or b'{}')
                    x0 = req['x']
                    t0 = time.time()
                    if req.get('fullcov'):
                        ypred, ypredvar, yconfvar, cov = \
                            server.predict_fullcov(x0)
                        payload = {'yfullcov': cov.tolist()}
                    else:
                        ypred, ypredvar, yconfvar = server.predict(x0)
                        payload = {}
                    payload.update({
                        'ypred': ypred.tolist(),
                        'ypredvar': ypredvar.tolist(),
                        'yconfvar': yconfvar.tolist(),
                        'latency_s': round(time.time() - t0, 4),
                    })
                    self._reply(200, payload)
                except (KeyError, ValueError, TypeError) as e:
                    self._reply(400, {'error': str(e)})
                except Exception as e:  # noqa: BLE001 — server-side failure:
                    # reply 500 instead of aborting the connection
                    self._reply(500, {'error': f'{type(e).__name__}: {e}'})
        return Handler

    def serve(self, host: str = '127.0.0.1', port: int = 8080,
              background: bool = False):
        """Start the HTTP server.  background=True returns (httpd, thread)
        immediately (for tests/embedding); otherwise blocks."""
        self._lead('serve')
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        if background:
            t = threading.Thread(target=self._httpd.serve_forever,
                                 daemon=True)
            t.start()
            return self._httpd, t
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._httpd.server_close()

    def shutdown(self):
        """Stop the HTTP server (if any) and join the dispatcher thread.
        On a mesh the dispatcher's last command returns the followers from
        :meth:`follow`; on a follower there is nothing to stop."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        with self._enqueue_lock:
            if not self._closed:
                self._closed = True
                self._queue.put(None)    # stop the dispatcher thread
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=60 if self._mesh is not None
                                  else 5)


def main(argv=None):
    ap = argparse.ArgumentParser(description='Serve a saved LCGP model.')
    ap.add_argument('model', help='path to a model .npz (LCGP.save)')
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, default=8080)
    ap.add_argument('--batch-size', type=int, default=256)
    ap.add_argument('--cpu', action='store_true',
                    help='serve on the CPU (default: the CUDA card)')
    ap.add_argument('--reload-dir', default=None,
                    help='directory POST /reload may load models from '
                         '(omitted = HTTP reload disabled)')
    args = ap.parse_args(argv)

    server = PredictServer(args.model, batch_size=args.batch_size,
                           warmup=False, reload_dir=args.reload_dir,
                           device='cpu' if args.cpu else 'cuda')
    secs = server.warmup()
    print(f'[lcgp_tpu_torch.serve] warm ({secs:.1f}s); '
          f'listening on {args.host}:{args.port}', flush=True)
    server.serve(args.host, args.port)


if __name__ == '__main__':
    main()
