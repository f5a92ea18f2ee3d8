"""Runs as CUDA graphs: a run's step captured once, replayed each step.

Counterpart of the JAX package's one-program runs: JAX jits a run and runs
its steps in a ``lax.fori_loop``, one compiled program whatever the step
count. Here a run captures its steady step once, as a
``torch.cuda.CUDAGraph`` on a static carry, and replays it ``n_steps``
times: ``ops/resident.make_tile_run`` (the carry: the tiles, the carried
forces, the settle sums and the run's counters) and ``loop_run``, the runs
whose step is one function of its carry (the sweep's: the state and its
lanes' occupancy; dense and tiered: the state and its tiles). The graphs
live as long as the run function, so an engine keeps them until it
rebuilds, as JAX's jit cache is keyed on the build. A run of 0 steps
captures them too (JAX's ``run(state, 0)`` compiles the program), so that
a caller can keep the capture out of a timed run.

``StepGraph`` chooses its path by the carry's device, like every wrapper in
the port: on CUDA tensors it captures a graph or raises (a step that reads a
value back to the host cannot be captured, and there is no eager fallback);
on CPU tensors its twin calls the same step function on the same static
buffers, so that the CPU tests exercise the carry, the copy-back and the
run's first and last steps. A mesh step's collectives are captured with it
where the mesh can capture them (``LocalMesh``; a ``DistMesh`` over NCCL,
whose kernels torch captures): a mesh whose collectives pass through host
memory (gloo on a CUDA device) has ``capturable`` False, and its engine's
``run`` refuses it rather than fall back (``run_eager`` runs it).
"""

from __future__ import annotations

import time

import torch
from torch.utils import _pytree as pytree

from particlesimulation_tpu_torch.ops.cuda import (advance, cell_pairs,
                                                   migrate, stencil, sweep)

# The launch counters of the kernels a step runs (the sweep's occupancy
# kernel among ``sweep.LAUNCHES``).
COUNTERS = (cell_pairs.LAUNCHES, advance.LAUNCHES, sweep.LAUNCHES,
            migrate.LAUNCHES, stencil.LAUNCHES)


class StepGraph:
    """A static carry and the step functions captured on it, by name.

    ``load(carry)`` copies a tree of tensors into the static carry (new
    buffers, and every graph dropped, where its structure, shapes, dtypes or
    devices differ from the last one's); ``carry()`` gives the static carry;
    ``step(name, fn)`` runs one step of ``fn(*carry) -> carry'``, a tree of
    the same structure, whose tensors are written back into the static
    carry (a tensor ``fn`` updated in place is left as it is). The first
    ``step`` under a name is a warm-up, the step run eagerly on a side
    stream (it builds and loads every kernel library, and fills the run's
    lazily made tables, before capture), followed by the capture of ``fn``;
    every later one replays the capture. Graphs share one memory pool: no
    tensor of it outlives a replay, since every output lands in the carry.
    What a capture reads outside the carry and the pool is held by the
    step function's closure.

    Launch counts: a wrapper counts its launch when its Python runs, so the
    capture's counts (``counters``, dicts of ints) are taken back, and each
    replay adds them. The CPU twin counts the same way, with its warm-up's
    counts standing for the capture's.
    """

    def __init__(self, counters=COUNTERS):
        self.counters = counters
        self.capture_s = {}      # name -> seconds of host time of its capture
        self.captures = 0        # captures made (the twin's first steps too)
        self._leaves = None
        self._spec = None
        self._sig = None
        self._graphs = {}        # name -> (graph or CPU fn, launches)
        self._pool = None

    def load(self, carry) -> None:
        leaves, spec = pytree.tree_flatten(carry)
        if not leaves or not all(isinstance(t, torch.Tensor) for t in leaves):
            raise TypeError("a carry is a tree of tensors")
        sig = [(t.shape, t.dtype, t.device) for t in leaves]
        dev = leaves[0].device
        if dev.type not in ("cpu", "cuda") or any(d != dev
                                                  for _, _, d in sig):
            raise ValueError(f"a carry lies on one CPU or CUDA device; got "
                             f"{sorted({str(d) for _, _, d in sig})}")
        if spec != self._spec or sig != self._sig:
            self.release()
            self._leaves = [torch.empty_like(t) for t in leaves]
            self._spec, self._sig = spec, sig
        for s, t in zip(self._leaves, leaves):
            s.copy_(t)

    def carry(self):
        return pytree.tree_unflatten(self._leaves, self._spec)

    def own(self, tree):
        """``tree`` with each tensor that shares memory with the static
        carry cloned: what a run hands out must not change when the carry
        is next loaded or stepped."""
        mine = {t.untyped_storage().data_ptr() for t in self._leaves}
        return pytree.tree_map(
            lambda t: (t.clone() if isinstance(t, torch.Tensor)
                       and t.untyped_storage().data_ptr() in mine else t),
            tree)

    def step(self, name, fn) -> None:
        if self._leaves is None:
            raise RuntimeError("no carry loaded")
        entry = self._graphs.get(name)
        if entry is None:
            self._graphs[name] = (self._capture(name, fn) if self._on_card()
                                  else self._twin(name, fn))
            return
        graph, launches = entry
        if self._on_card():
            graph.replay()
        else:
            saved = self._read()
            self._body(graph)
            self._write(saved)
        self._add(launches)

    def capture(self, name, fn) -> None:
        """Capture ``fn`` under ``name`` where it is not captured yet (its
        warm-up steps the carry); no replay."""
        if name not in self._graphs:
            self.step(name, fn)

    def release(self) -> None:
        """Drop every graph and the static carry."""
        if self._leaves is not None and self._on_card():
            for graph, _ in self._graphs.values():
                graph.reset()
        self._graphs = {}
        self._pool = None
        self._leaves = self._spec = self._sig = None

    @property
    def names(self):
        """The names of the step functions captured so far."""
        return tuple(self._graphs)

    @property
    def pool(self):
        """The graphs' memory pool handle (None before a capture)."""
        return self._pool

    def _on_card(self) -> bool:
        return self._leaves[0].device.type == "cuda"

    def _body(self, fn) -> None:
        """One step of ``fn`` on the static carry, its outputs written back."""
        out, spec = pytree.tree_flatten(fn(*self.carry()))
        if spec != self._spec:
            raise ValueError(f"a step gave a carry of structure {spec}, not "
                             f"{self._spec}")
        where = {t.data_ptr(): i for i, t in enumerate(self._leaves)
                 if t.numel()}
        for i, (s, o) in enumerate(zip(self._leaves, out)):
            if o is s or (o.data_ptr() == s.data_ptr()
                          and o.shape == s.shape and o.stride() == s.stride()):
                continue
            if o.shape != s.shape or o.dtype != s.dtype:
                raise ValueError(f"a step gave carry tensor {i} as "
                                 f"{o.dtype}{tuple(o.shape)}, not "
                                 f"{s.dtype}{tuple(s.shape)}")
            if where.get(o.data_ptr(), i) != i:
                raise ValueError(f"a step returned carry tensor "
                                 f"{where[o.data_ptr()]} in place {i}")
            s.copy_(o)

    def _capture(self, name, fn):
        dev = self._leaves[0].device
        with torch.cuda.device(dev):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._body(fn)
            main.wait_stream(side)
            saved = self._read()
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=torch.cuda.Stream()):
                    self._body(fn)
            finally:
                launches = self._delta(saved)
                self._write(saved)
            self.capture_s[name] = time.perf_counter() - t0
            self.captures += 1
        if self._pool is None:
            self._pool = graph.pool()
        return graph, launches

    def _twin(self, name, fn):
        saved = self._read()
        self._body(fn)
        self.capture_s[name] = 0.0
        self.captures += 1
        return fn, self._delta(saved)

    def _read(self):
        return [dict(c) for c in self.counters]

    def _write(self, saved) -> None:
        for c, s in zip(self.counters, saved):
            c.update(s)

    def _delta(self, saved):
        return [{k: c[k] - s.get(k, 0) for k in c}
                for c, s in zip(self.counters, saved)]

    def _add(self, launches) -> None:
        for c, d in zip(self.counters, launches):
            for k, v in d.items():
                c[k] += v


class GraphedRun:
    """A run whose steps replay graphs: ``run(state, n_steps)`` replays its
    step graphs on ``graphs`` (the twin on CPU tensors), and a run of 0
    steps captures them; ``run.eager(state, n_steps)``, the plain loop,
    dispatches each kernel of each step from Python. Both give the same
    bits."""

    def __init__(self, graphed, eager, graphs: StepGraph):
        self._graphed = graphed
        self.eager = eager
        self.graphs = graphs

    def __call__(self, state, n_steps: int):
        return self._graphed(state, n_steps)

    def release(self) -> None:
        """Drop the graphs and the static carry (the next run captures
        anew)."""
        self.graphs.release()


def loop_run(start, step, finish) -> GraphedRun:
    """The ``GraphedRun`` of a run whose steps are one function of a carry:
    ``start(state)`` gives the first carry (a tree of tensors),
    ``step(*carry)`` the next (of the same structure, shapes and dtypes),
    ``finish(carry, state)`` the run's final state. The carry is loaded
    into a ``StepGraph`` (the caller's tensors are not written) and "step"
    replays; a run of 0 steps captures it and returns ``finish`` of the
    first carry. What ``finish`` hands out is cloned where it shares the
    static carry."""

    def run_eager(state, n_steps: int):
        carry = start(state)
        for _ in range(n_steps):
            carry = step(*carry)
        return finish(carry, state)

    graphs = StepGraph()

    def run(state, n_steps: int):
        carry = start(state)
        if n_steps == 0:
            out = finish(carry, state)
            graphs.load(carry)
            del carry
            graphs.capture("step", step)
            return out
        graphs.load(carry)
        del carry
        for _ in range(n_steps):
            graphs.step("step", step)
        return graphs.own(finish(graphs.carry(), state))

    return GraphedRun(run, run_eager, graphs)


def release(run) -> None:
    """Drop a run function's graphs (None: no run built yet)."""
    if run is not None:
        run.release()
