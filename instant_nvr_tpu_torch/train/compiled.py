"""The port's counterpart of the JAX package's compiled programs: the train
step as a CUDA graph (``torch.cuda.CUDAGraph``), captured once per static
key and replayed (``instant_nvr_tpu/train/loop.py:186``'s ``jax.jit`` of
``make_train_step``), for every optimizer, under ``remat`` and across NCCL
ranks.  The other programs capture through the same machinery
(:func:`capture`, :func:`replay`, :func:`side_stream`, :class:`Graph`):
the eval frame (``eval/runner.py:CapturedFrame``), the occupancy cube
(``eval/mesh.py:CapturedCube``) and the eval LPIPS
(``eval/evaluator.py:CapturedLpips``); :func:`program_route` is their
route.

:func:`step_route` chooses, before a run, between this route
(``captured``) and the eager step of ``train/step.py:make_train_step``
(``eager``, with its reason); the loop, ``train_net`` and ``bench`` print
it.  Nothing falls back: a capture or replay that fails raises, and
:class:`CapturedStep` refuses a CPU device and a Gloo group.

A :class:`CapturedStep` keys its graphs as jit would retrace: the model
and render specs and loss weights it was made with, and the batch's keys,
shapes and dtypes (the budgets follow from its ray count).  For each key:

  - static input buffers for the batch and the draws: each call copies the
    batch in, and makes the draws eagerly with ``draw_render`` from the
    caller's generator (bit for bit the eager step's draws) into them;
  - ``WARMUP_STEPS`` eager steps of the capturable body
    (``train/step.py:make_step_body``) on a side stream (one a device,
    :func:`side_stream`, shared by every captured program), PyTorch's
    whole-network capture recipe: they build the kernels, the constants,
    the scatter workspaces of that stream, the optimizer's state and the
    libraries' handles, so that the capture allocates and copies nothing
    from the host;
  - then the capture on that stream, and a replay per step after; a
    replay raises if the parameters or the optimizer's moments are no
    longer the tensors the graph captured (:func:`held_tensors`).

Across NCCL ranks every rank makes the same calls, so each warms up and
captures at the same step; the warm-up runs on the side stream, and so
do its collectives (the gradient all-reduce, the counts' and the stats'),
which the capture then records.

The optimizer update reads its per-step scalars from a
:class:`~.state.DeviceSchedule` at a device step counter that follows
``state.step`` (set from it whenever they differ, as after a resume);
``state.step`` and the optimizer's host step counts advance on the host.
The stats a step returns are the graph's static outputs: a caller that
keeps one past the next step clones it.

The kernels' ``.launches`` counters count Python calls, which a replay
does not make: :func:`capture` records each graph's launches and takes
them back out of the counters (the capture launched nothing), and
:func:`replay` adds them on every replay.  ``CapturedStep.fill_bytes``
counts the bytes each call copies into the graphs' static inputs.

The spans (``utils/telemetry.py``, while a profiler records) lie around
the captured region, never inside it (a graph does not replay host code):
a step's ``step`` (unit: ``state.step``) holds ``step.bind``,
``step.draws``, ``step.fill`` and one of ``step.warmup``,
``step.capture`` + ``step.replay``, or ``step.replay``; a captured eval
program's call holds ``<name>.copy_in`` and one of ``<name>.warmup``,
``<name>.capture`` + ``<name>.replay`` or ``<name>.replay``
(:attr:`CapturedProgram.name`: ``frame``, ``cube``, ``lpips``).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models import inb
from ..ops import hashgrid, knn, mlp_wgrad, scatter
from ..parallel import mesh as pmesh
from ..renderer.inb_renderer import RenderSpec
from ..utils import telemetry
from .state import DEVICE_OPTIMIZERS, DeviceSchedule, TrainState
from .step import LossWeights, PatchLossFn, draw_render, make_step_body

WARMUP_STEPS = 3
# steps the first device schedule covers; a run that goes past them gets
# tables of twice the size and its graphs captured again
SCHEDULE_STEPS = 4096

# the counters of every kernel wrapper a captured program may launch
# (``exact_scatter_add.calls`` counts the exact route's ``index_add_``)
_COUNTERS = ((knn.knn_blend, "launches"), (knn.knn_topk, "launches"),
             (scatter.segmented_scatter_add, "launches"),
             (scatter.onehot_scatter_add, "launches"),
             (scatter.sorted_scatter_add, "launches"),
             (scatter.exact_scatter_add, "calls"),
             (hashgrid.fused_encode, "launches"),
             (hashgrid.fused_encode_backward, "launches"),
             (mlp_wgrad.mlp_wgrad, "launches"))

Launches = Tuple[int, ...]


def _counts() -> Launches:
    return tuple(getattr(fn, attr) for fn, attr in _COUNTERS)


def _set_counts(counts: Launches) -> None:
    for (fn, attr), n in zip(_COUNTERS, counts):
        setattr(fn, attr, n)


def capture(fn: Callable, stream: torch.cuda.Stream):
    """Capture ``fn()`` into a new CUDA graph on ``stream`` -> (graph, its
    output, the kernel launches it holds).  The counters are left as they
    were before the capture.  Other threads may use the card meanwhile
    (``thread_local``: the prefetcher's copies)."""
    before = _counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        out = fn()
    launches = tuple(a - b for a, b in zip(_counts(), before))
    _set_counts(before)
    return graph, out, launches


def replay(graph: torch.cuda.CUDAGraph, launches: Launches) -> None:
    """Replay ``graph`` on the current stream and count its launches."""
    graph.replay()
    _set_counts(tuple(a + b for a, b in zip(_counts(), launches)))


_streams: Dict[torch.device, torch.cuda.Stream] = {}


def side_stream(device) -> torch.cuda.Stream:
    """The one stream of ``device`` that every captured program warms up
    and captures on: the scatter workspaces are kept per stream, so one
    stream keeps one set of them."""
    device = torch.device(device)
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device)
    return stream


def on_side_stream(fn: Callable, stream: torch.cuda.Stream, device):
    """``fn()`` on ``stream``, ordered after the current stream's work and
    before its later work; the tensors it returns (a dict) are marked as
    used by the current stream."""
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = fn()
    cur.wait_stream(stream)
    for v in out.values():
        if torch.is_tensor(v):
            v.record_stream(cur)
    return out


def signature(tensors: Dict[str, torch.Tensor]) -> tuple:
    """The static key of a dict of tensors: each key with its tensor's
    shape, dtype and device."""
    return tuple((k, tuple(v.shape), v.dtype, v.device)
                 for k, v in sorted(tensors.items()))


def static_copy(tensors: Dict[str, torch.Tensor], device=None) -> Dict[str, torch.Tensor]:
    """A buffer of each tensor's shape and dtype, on ``device`` (default
    the tensor's own)."""
    return {k: torch.empty(v.shape, dtype=v.dtype,
                           device=v.device if device is None else device)
            for k, v in tensors.items()}


def fill(static: Dict[str, torch.Tensor], tensors: Dict[str, torch.Tensor]) -> None:
    """Copy ``tensors`` into their static buffers (on the current stream)."""
    for k, v in tensors.items():
        static[k].copy_(v)


class Route(NamedTuple):
    """A step route: ``captured`` or ``eager``, and why eager."""
    name: str
    reason: str = ""

    def __str__(self) -> str:
        return self.name + (f" ({self.reason})" if self.reason else "")


def step_route(cfg, device, eager: bool = False, world: Optional[int] = None,
               backend: Optional[str] = None) -> Route:
    """The train step's route for ``cfg`` on ``device``, chosen before the
    run: ``captured`` on a CUDA device, for every optimizer, under
    ``remat`` and across ranks on NCCL (whose collectives a graph
    captures); ``eager`` with its reason for ``--eager`` (``eager``), a CPU
    device, ranks on Gloo and ``--detect_anomaly``.  ``world`` and
    ``backend`` default to the process group's."""
    device = torch.device(device)
    world = pmesh.world_size() if world is None else world
    backend = pmesh.backend() if backend is None else backend
    if eager:
        return Route("eager", "--eager")
    if device.type != "cuda":
        return Route("eager", f"CUDA graphs need a CUDA device, not {device.type}")
    if world > 1 and backend != "nccl":
        return Route("eager", f"--distributed over {world} ranks on {backend}: "
                              f"only NCCL's collectives can be captured")
    if torch.is_anomaly_enabled():
        return Route("eager", "--detect_anomaly: anomaly mode checks each op "
                              "on the host")
    return Route("captured")


def program_route(device, eager: bool = False) -> Route:
    """The route of a captured eval program (the frame, the cube, the eval
    LPIPS): ``captured`` on a CUDA device unless ``eager``; ``eager`` with
    its reason otherwise."""
    if eager:
        return Route("eager", "--eager")
    if torch.device(device).type != "cuda":
        return Route("eager", f"CUDA graphs need a CUDA device, not "
                              f"{torch.device(device).type}")
    return Route("captured")


def held_tensors(state: TrainState) -> tuple:
    """What a captured step's graph holds by address besides its own
    buffers: the model's parameters and the optimizer's moments (an
    optimizer ``load_state_dict`` of other tensors replaces the moments)."""
    return tuple(state.model.parameters()) + tuple(
        v for st in state.optimizer.state.values() for v in st.values()
        if torch.is_tensor(v))


def same_tensors(a: tuple, b: tuple) -> bool:
    """Whether two tuples hold the very same tensor objects."""
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


class Graph:
    """One static key of a captured program: its static input buffers
    (``inputs[name]``, one dict of tensors a name), the eager warm-up calls
    made, and the graph with its static outputs and launches once
    captured."""

    def __init__(self, inputs: Dict[str, Dict[str, torch.Tensor]], device=None):
        self.inputs = {name: static_copy(d, device) for name, d in inputs.items()}
        self.nbytes = sum(v.numel() * v.element_size()
                          for d in self.inputs.values() for v in d.values())
        self.warm = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Dict[str, torch.Tensor] = {}
        self.launches: Launches = ()
        self.held: tuple = ()
        self.holds = None           # an eval program's model, whose id keys it

    def fill(self, inputs: Dict[str, Dict[str, torch.Tensor]]) -> None:
        for name, d in inputs.items():
            fill(self.inputs[name], d)


class CapturedProgram:
    """The graphs of a captured eval program (the frame, the cube, the
    LPIPS), one :class:`Graph` per static key: a call fills the key's
    static inputs; the key's first call runs eagerly on the side stream
    (the warm-up: kernels, constants, handles), the second captures and
    replays, each later one replays.  With ``max_graphs`` the keys used
    last keep their graphs (and what each holds), the older ones are
    dropped.  ``name`` prefixes its spans."""

    name = "program"

    def __init__(self, max_graphs: Optional[int] = None):
        self.graphs: Dict[tuple, Graph] = {}
        self.max_graphs = max_graphs
        self.captures = 0
        self.replays = 0

    def run(self, key: tuple, inputs: Dict[str, Dict[str, torch.Tensor]], device,
            fn: Callable[[Dict[str, Dict[str, torch.Tensor]]], Dict[str, torch.Tensor]],
            holds=None) -> Dict[str, torch.Tensor]:
        """``fn(static inputs)`` for ``inputs`` on the key's graph -> its
        outputs (the graph's static tensors once captured: read them before
        the next call).  ``holds`` is kept with the graph (a model whose
        ``id`` is in the key)."""
        g = self.graphs.pop(key, None)
        if g is None:
            if self.max_graphs and len(self.graphs) >= self.max_graphs:
                self.graphs.pop(next(iter(self.graphs)))     # the least recently used
            g = Graph(inputs, device)
            g.holds = holds
        self.graphs[key] = g
        with telemetry.span(self.name + ".copy_in"):
            g.fill(inputs)
        stream = side_stream(device)
        if not g.warm:
            g.warm = 1
            with telemetry.span(self.name + ".warmup"):
                return on_side_stream(lambda: fn(g.inputs), stream, device)
        if g.graph is None:
            with telemetry.span(self.name + ".capture"):
                g.graph, g.out, g.launches = capture(lambda: fn(g.inputs), stream)
            self.captures += 1
        with telemetry.span(self.name + ".replay"):
            replay(g.graph, g.launches)
        self.replays += 1
        return g.out


class CapturedStep:
    """The train step replayed as CUDA graphs; called as
    ``make_train_step``'s step: ``(state, batch, generator=None,
    draws=None) -> (state, stats)``, the stats being the graph's static
    outputs (see the module doc).  ``n_steps`` is how many steps the first
    device schedule covers."""

    def __init__(self, mspec: inb.ModelSpec, rspec: RenderSpec, lw: LossWeights,
                 patch_loss_fn: Optional[PatchLossFn] = None,
                 n_steps: int = SCHEDULE_STEPS):
        self.mspec, self.rspec, self.lw = mspec, rspec, lw
        self.body = make_step_body(mspec, rspec, lw, patch_loss_fn)
        self.n_steps = int(n_steps)
        self.graphs: Dict[tuple, Graph] = {}
        self.captures = 0
        self.replays = 0
        self.fill_bytes = 0
        self._bound = None          # (model, optimizer) the graphs hold
        self.sched: Optional[DeviceSchedule] = None
        self.dstep: Optional[torch.Tensor] = None
        self._dstep_at = None       # state.step the device counter holds

    def _bind(self, state: TrainState, device: torch.device) -> None:
        """Check the state, and (re)make the schedule when it is another
        state's or too short; the graphs go with it."""
        if not isinstance(state.optimizer, DEVICE_OPTIMIZERS):
            raise TypeError(f"the captured step updates from a device schedule, "
                            f"which {type(state.optimizer).__name__} has not")
        steps = {int(st["step"]) for st in state.optimizer.state.values()
                 if "step" in st}
        if steps - {state.step}:
            raise ValueError(f"optimizer step counts {sorted(steps)} differ from "
                             f"the state's step {state.step}")
        bound = (state.model, state.optimizer)
        if (self._bound is not None and bound[0] is self._bound[0]
                and bound[1] is self._bound[1] and state.step < self.sched.n_steps):
            return
        n = max(self.n_steps, state.step + 1,
                2 * self.sched.n_steps if self.sched is not None else 0)
        self.sched = DeviceSchedule(state.optimizer, state.schedule, n, device)
        self.dstep = torch.zeros((), dtype=torch.int64, device=device)
        self._dstep_at = 0
        self.graphs.clear()
        self._bound = bound

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor],
                 generator: torch.Generator | None = None,
                 draws: Dict[str, torch.Tensor] | None = None):
        device = batch["ray_o"].device
        if device.type != "cuda":
            raise RuntimeError(f"the captured step runs on a CUDA device, not "
                               f"{device}; the eager step (make_train_step) "
                               f"runs on the CPU")
        world = pmesh.world_size()
        if world > 1 and pmesh.backend() != "nccl":
            raise RuntimeError(f"the captured step's collectives run on NCCL, not "
                               f"{pmesh.backend()} (step_route gives it the eager step)")
        with telemetry.span("step", state.step):
            with telemetry.span("step.bind"):
                self._bind(state, device)
            if draws is None:       # the whole batch's draws on every rank
                with telemetry.span("step.draws"):
                    draws = draw_render(self.mspec, self.rspec,
                                        batch["ray_o"].shape[0] * world, generator, device)
            inputs = {"batch": batch, "draws": draws}
            key = signature(batch)
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = Graph(inputs)
            with telemetry.span("step.fill"):
                g.fill(inputs)
                if self._dstep_at != state.step:
                    self.dstep.fill_(state.step)
            self.fill_bytes += g.nbytes

            def run():
                return self.body(state, g.inputs["batch"], g.inputs["draws"],
                                 self.sched, self.dstep)

            if g.graph is None and g.warm < WARMUP_STEPS:
                with telemetry.span("step.warmup"):
                    stats = on_side_stream(run, side_stream(device), device)
                g.warm += 1
            else:
                if g.graph is None:
                    with telemetry.span("step.capture"):
                        g.graph, g.out, g.launches = capture(run, side_stream(device))
                    g.held = held_tensors(state)
                    self.captures += 1
                elif not same_tensors(held_tensors(state), g.held):
                    raise RuntimeError("the model's parameters or the optimizer's "
                                       "moments are other tensors than the graph "
                                       "captured (a load_state_dict after the "
                                       "capture?): make a new CapturedStep")
                with telemetry.span("step.replay"):
                    replay(g.graph, g.launches)
                self.replays += 1
                stats = g.out
            state.optimizer.advance_steps()
            state.step += 1
            self._dstep_at = state.step
        return state, stats
