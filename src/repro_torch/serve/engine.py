"""Slot-based continuous-batching serving engine (port of
``repro.serve.engine``: ``prepare_params``, ``PREPARE_CALLS``, the
``Engine`` protocol, ``ServeEngine`` with per-slot bucketed prefill, the
decode-chunk loop, the group-layout memo, per-request KV precision, tier
migration, the tier-serialized mode, seeded sampling and self-speculative
rounds, overload control and telemetry hooks, and the batch-at-a-time
``BatchServeEngine``).

* **Weight preload** — at construction the float params are converted ONCE
  into ``QuantizedWeight`` planes (``prepare_params``); with a
  ``PrecisionSchedule`` that is the 8-bit MSB-first superplane store and
  every tier decodes against it by plane-prefix truncation, with zero
  further preparation (``PREPARE_CALLS`` must not move after construction).
  ``packed=True`` stores one uint8 per weight instead of int8 planes.
* **Mixed-tier decode batches** — admission fills any free slot; each
  decode chunk derives a ``(tier, rows)`` group layout from the occupied
  slots' tiers plus a slot permutation, and every projection runs one
  group-switching GEMM over all tiers (``models.layers.linear``).
  ``mixed_tiers=False`` is the tier-serialized mode: a decode batch runs
  at ONE tier (``Runtime.for_tier``) and admission takes only that tier's
  requests until the batch drains (``tier_switches`` counts the changes).
* **Per-request KV precision** — a schedule with ``kv_tiers`` gets ONE
  mixed per-slot KV arena (``KVCache`` byte lanes, ``kv_bits=
  schedule.kv_modes``); each admission resets its slot and sets the
  slot's tier code (``slots.fill_kv_tier``) before the prefill writes, so
  the request's K/V are stored at its tier's precision (bf16, int8 or
  int4).
* **Tier migration** — ``RequestHandle.set_tier`` re-tags a QUEUED
  request; a RUNNING one (mixed mode) has its slot's KV lanes requantized
  in place when its KV code changes (``slots.migrate_kv_tier``), and its
  weight plane prefix switches at the next group layout.
* **Admission policy** — ``scheduler_policy`` (FIFO by default;
  ``SLOPolicy`` for deadline slack, with ``auto_tier`` retagging a
  deadlined request to a tier that fits at admission).
* **Decode chunks** — ``decode_chunk`` steps run back to back on the
  device with an active-slot mask; the host reads the chunk's tokens with
  ONE copy at its end and only then admits/retires requests.
* **Sampling** — each slot carries its request's threefry key, a draw
  counter, temperature and top-k (``spec.sampling``); rows at temperature
  0 take the raw-logits argmax exactly, and a sampled stream depends only
  on (seed, draw index), never on the batch.
* **Self-speculative rounds** — when an occupied slot's request sets
  ``spec``, the round drafts k tokens with the spec slots re-tagged to
  their draft tier (a plane prefix of the same store), rolls their draft
  KV lengths and SSM rows back, verifies the (k+1)-token window in ONE
  ``LM.verify_step`` at the normal layout and emits the accepted prefix
  plus a correction token
  (``spec.speculate``).  Plain slots decode k ordinary steps in the same
  batches.
* **Overload survival** — ``preempt(uid)`` copies a RUNNING slot's cache
  (every tensor of its ``KVCache``: lanes, scale rows, length, tier code;
  of its ``SSMCache``: conv window and SSD state)
  to the host with its decode state as a :class:`SuspendedState`
  (optionally spilled to ``spill_dir`` through ``repro_torch.checkpoint``);
  the request waits at its original submission tick and resumes
  prefill-free, in any slot, token-identical.  ``SLOPolicy``'s
  ``preempt``, ``shed``, ``tenant_weights`` and ``time_slice`` drive it
  between rounds; ``cancel`` drops QUEUED and SUSPENDED requests.
* **Telemetry** — ``telemetry=`` (``repro_torch.telemetry.Telemetry``,
  duck-typed) receives every lifecycle and dispatch hook; every hook site
  is guarded by ``telemetry is not None``, and the engine itself never
  synchronizes with the device (only a profiling telemetry fences).
* **Tensor-parallel serving** — ``mesh=`` (``launch.mesh.make_serve_mesh``)
  makes the engine one rank of an SPMD group: every rank runs the same
  engine on the same requests (host scheduling is deterministic, so each
  takes the same decisions), keeps its N-shard of the prepared store and
  its KV-head shard of the arena (``distributed.sharding_rules``), and
  runs prefill, decode, migration and sampling with ``Runtime.tp`` set, so
  collectives happen only inside ``linear`` (the quantized code wire,
  ``distributed.tp_serve``).  Every replicated value, the tokens included,
  is bit-equal across ranks and to the unsharded engine.  A preemption
  snapshot gathers the KV-head shards (the host copy and its spill files
  hold the unsharded engine's bytes) and a resume slices them back.  Only
  rank 0 records telemetry and writes spill files; speculation on a mesh
  raises.

The scheduler clock is the number of decode steps executed
(``ServeEngine.clock``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Any, Dict, List, Optional, Protocol, Sequence, Set,
                    Tuple, runtime_checkable)

import numpy as np
import numpy.typing as npt
import torch

from repro_torch.checkpoint import checkpoint as checkpoint_lib
from repro_torch.core.policy import INTEGER_BACKENDS, PrecisionPolicy
from repro_torch.device import resolve_device
from repro_torch.distributed import comm, sharding_rules, tp_serve
from repro_torch.kernels import _build, ops
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve import slots as slots_lib
from repro_torch.serve.handle import RequestHandle, RequestStatus, TokenEvent
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import (RunningEntry, Scheduler,
                                         SchedulerPolicy, SLOPolicy)
from repro_torch.spec import sampling as sampling_lib
from repro_torch.spec import speculate as spec_lib

__all__ = ["Request", "Engine", "ServeEngine", "BatchServeEngine",
           "EngineStats", "SuspendedState", "prepare_params", "prepare_tree",
           "PREPARE_CALLS"]

# Mixed-tier group layout: the tuple of (tier name, rows) runs describing a
# tier-sorted decode batch (see Runtime.for_groups).
GroupLayout = Tuple[Tuple[str, int], ...]

# Global weight-preparation counter: every prepare_params call (one
# quantize + decompose sweep over the params) bumps it.
PREPARE_CALLS = 0

def _layer_name(path: Tuple[Any, ...]) -> str:
    """("layers", 3, "pos0", "attn", "q_proj", "w") -> layers.pos0.attn.q_proj"""
    parts = [str(p) for p in path if not isinstance(p, int)]
    if parts and parts[-1] == "w":
        parts = parts[:-1]
    return ".".join(parts)


def _prepare_2d(w: torch.Tensor, prec: Any, superplane: bool,
                packed: bool) -> ops.QuantizedWeight:
    w = w.to(torch.float32)
    if superplane:
        return ops.prepare_superplane(w, signed=prec.w_signed, packed=packed)
    return ops.prepare_weight(w, prec, packed=packed)


def _stack_prepared(qws: List[ops.QuantizedWeight]) -> ops.QuantizedWeight:
    """Per-expert prepared weights as one expert-stacked store (planes
    [E, P, K, N] or packed [E, K, N], scale [E, 1, N]), the reference's
    ``jax.vmap(prep)`` layout."""
    def stack(field: str) -> Optional[torch.Tensor]:
        ts = [getattr(q, field) for q in qws]
        return None if ts[0] is None else torch.stack(ts)
    return dataclasses.replace(qws[0], planes=stack("planes"),
                               packed=stack("packed"), scale=stack("scale"))


def prepare_tree(tree: Any, policy: PrecisionPolicy, *,
                 superplane: bool = False, packed: bool = False,
                 prefix: Tuple[Any, ...] = (),
                 paths: Optional[List[str]] = None) -> Any:
    """A copy of ``tree`` (dicts and lists of tensors) with every projection
    weight — a ``w`` of 2 or more dims outside the embedding, the MoE
    router and the conv — replaced by its QuantizedWeight (the superplane
    store if ``superplane``; byte-packed if ``packed``).  An expert-stacked
    ``w`` [E, K, N] is prepared one [K, N] slice at a time and stacked.
    ``prefix`` is the key path of ``tree`` inside the full params, which
    names each weight for the policy lookup.  Does not count as a
    ``prepare_params`` call: it is the per-subtree worker (``LM.init``'s
    prepare hook)."""
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            path = prefix + (key,)
            is_proj = (key == "w" and isinstance(val, torch.Tensor)
                       and val.ndim >= 2 and not any(
                           skip in str(p) for p in path
                           for skip in ("embed", "router")))
            if is_proj:
                prec = policy.lookup(_layer_name(path))
                if val.ndim == 2:
                    out[key] = _prepare_2d(val, prec, superplane, packed)
                else:
                    out[key] = _stack_prepared([
                        _prepare_2d(w2, prec, superplane, packed)
                        for w2 in val.reshape((-1,) + val.shape[-2:])])
                if paths is not None:
                    paths.append(".".join(map(str, path)))
            else:
                out[key] = prepare_tree(val, policy, superplane=superplane,
                                        packed=packed, prefix=path,
                                        paths=paths)
        return out
    if isinstance(tree, list):
        return [prepare_tree(v, policy, superplane=superplane, packed=packed,
                             prefix=prefix + (i,), paths=paths)
                for i, v in enumerate(tree)]
    return tree


def prepare_params(params: Any, policy: PrecisionPolicy, model: LM,
                   packed: bool = False,
                   superplane: bool = False) -> Tuple[Any, List[str]]:
    """Quantize + decompose every policy-covered projection weight offline.
    Returns (prepared params, key paths of the prepared weights)."""
    del model   # the reference's signature; the names come from the paths
    global PREPARE_CALLS
    PREPARE_CALLS += 1
    paths: List[str] = []
    out = prepare_tree(params, policy, superplane=superplane, packed=packed,
                       paths=paths)
    return out, paths


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _params_prepared(params: Any) -> bool:
    return any(isinstance(l, ops.QuantizedWeight) for l in _leaves(params))


def _ensure_prepared(params: Any, rt: Runtime, model: LM,
                     packed: bool) -> Any:
    """Weight preload: prepare the plane tree once at construction unless
    the caller already did.  A schedule gets the superplane store."""
    if _params_prepared(params):
        return params
    if rt.schedule is not None:
        return prepare_params(params, rt.schedule.prepare_policy(), model,
                              packed=packed, superplane=True)[0]
    if rt.policy.default.backend in INTEGER_BACKENDS:
        return prepare_params(params, rt.policy, model, packed=packed)[0]
    return params


def quantized_paths(params: Any) -> List[str]:
    """keystr paths of the prepared weights, named in the reference's
    layout (the per-layer dicts stacked into ``periods``), as its engines
    report them: one path per projection of a period."""
    paths: List[str] = []

    def walk(tree: Any, path: str) -> None:
        if isinstance(tree, ops.QuantizedWeight):
            paths.append(path)
        elif isinstance(tree, dict):
            for key in sorted(tree):
                walk(tree[key], f"{path}[{key!r}]")

    layers = params.get("layers")
    walk({**{k: v for k, v in params.items() if k != "layers"},
          **({"periods": layers[0]} if layers else {})}, "")
    return paths


def _validate_request(request: Request, max_len: int,
                      seen_uids: Set[int]) -> None:
    """Non-empty prompt, positive decode budget, fits the arena, fresh uid."""
    plen = len(request.prompt)
    if plen == 0:
        raise ValueError(f"request {request.uid}: empty prompt")
    if request.max_new_tokens < 1:
        raise ValueError(f"request {request.uid}: max_new_tokens must be "
                         f">= 1, got {request.max_new_tokens}")
    if plen + request.max_new_tokens > max_len:
        raise ValueError(
            f"request {request.uid}: prompt ({plen}) + max_new_tokens "
            f"({request.max_new_tokens}) exceeds max_len {max_len}")
    if request.uid in seen_uids:
        raise ValueError(f"request uid {request.uid} already submitted "
                         "(results are keyed by uid)")


@dataclasses.dataclass
class EngineStats:
    """Work accounting.  A decode chunk serving several tiers counts its
    steps toward every occupied tier (``decode_steps_by_tier``) while
    ``tokens_by_tier`` counts each tier's own active slot-steps.
    ``prefill_seconds`` / ``decode_seconds`` are host wall time around
    each prefill / decode chunk; each ends in a host copy of its tokens,
    which waits for the device.

    A speculative round of draft depth k counts k draft-tier steps
    (``spec_draft_steps``) and ONE verify window (``spec_verify_steps``),
    all k+1 in ``decode_steps``.  ``spec_drafted`` counts proposed draft
    tokens, ``spec_accepted`` those the verify accepted and
    ``spec_emitted`` every token a round emitted, so ``spec_accepted /
    spec_drafted`` is the acceptance rate and ``spec_verify_steps /
    spec_emitted`` the verify steps per emitted token.  The identity
    ``decode_slot_steps + decode_idle_slot_steps == decode_steps *
    max_batch`` holds through speculative rounds.

    ``tier_switches`` moves only in the tier-serialized mode (a decode
    batch started at another tier than the last); ``tier_migrations``
    counts ``set_tier`` on RUNNING requests and ``kv_migrations`` those
    that requantized a live KV lane (the two tiers' KV codes differ);
    ``tier_autoselects`` the admission-time retags of
    ``SLOPolicy(auto_tier=True)`` (and its downtiers at submit).

    Overload: ``preemptions`` counts RUNNING slots suspended, ``resumes``
    their prefill-free re-admissions, ``sheds`` the requests refused at
    submit or cancelled, ``spill_bytes`` the snapshot bytes written to
    ``spill_dir`` and ``time_slice_preemptions`` the best-effort slots
    preempted by ``SLOPolicy(time_slice=N)``.  ``decode_dispatches`` holds,
    per group layout, the kernel launches of one decode step
    (``count_dispatches=True`` or a profiling telemetry)."""

    prefills: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0
    decode_chunks: int = 0
    decode_slot_steps: int = 0
    decode_idle_slot_steps: int = 0
    tier_switches: int = 0
    mixed_tier_chunks: int = 0
    tier_migrations: int = 0
    kv_migrations: int = 0
    tier_autoselects: int = 0
    preemptions: int = 0
    resumes: int = 0
    sheds: int = 0
    spill_bytes: int = 0
    time_slice_preemptions: int = 0
    spec_rounds: int = 0
    spec_draft_steps: int = 0
    spec_verify_steps: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_emitted: int = 0
    layout_cache_hits: int = 0
    layout_cache_misses: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    decode_steps_by_tier: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    tokens_by_tier: Dict[str, int] = dataclasses.field(default_factory=dict)
    decode_dispatches: Dict[GroupLayout, int] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class SuspendedState:
    """Host-side snapshot of one preempted request (``ServeEngine.preempt``):
    the request, the tokens already emitted, the decode budget still owed,
    the last emitted token (the next decode step's input), the sampling
    draw counter, and the slot's cache (``slots.slot_snapshot``: every
    tensor of every layer's batch-1 ``KVCache`` or ``SSMCache``, copied to
    the host).  The
    snapshot fits any slot.  ``cache`` is None once it was spilled to disk
    (``spill_step`` names the checkpoint step under ``spill_dir``);
    ``nbytes`` is its size either way."""

    request: Request
    tokens: List[int]
    remaining: int
    last_token: int
    cache: Optional[Any]
    spill_step: Optional[int] = None
    nbytes: int = 0
    draws: int = 0


class _DeferredErrors:
    """A raising ``on_token`` callback must not abort a scheduling round
    midway (host bookkeeping would fall out of step with the device
    state): the engines route callback errors here
    (``RequestHandle._push(defer=...)``) and re-raise the first one at the
    end of the round."""

    _deferred_error: Optional[BaseException] = None

    def _defer_error(self, err: BaseException) -> None:
        if self._deferred_error is None:
            self._deferred_error = err

    def _raise_deferred(self) -> None:
        if self._deferred_error is not None:
            err, self._deferred_error = self._deferred_error, None
            raise err


@runtime_checkable
class Engine(Protocol):
    """The serving surface both engines implement.  ``submit`` validates
    and queues one request and returns its streaming handle; ``step`` runs
    one scheduling round and returns the tokens it emitted; ``drain`` steps
    until idle and returns every finished request's tokens; ``run`` submits
    a list, drains and collects.  ``retire`` drops a terminal request's
    host state and returns its tokens.  ``clock`` is the scheduler clock
    (decode steps executed) that submission times and deadlines are priced
    in.  ``cancel`` drops a request that is not running (QUEUED, or
    SUSPENDED on engines that preempt): its handle turns SHED."""

    def submit(self, request: Request) -> RequestHandle: ...

    def step(self) -> List[TokenEvent]: ...

    def drain(self) -> Dict[int, List[int]]: ...

    def run(self, requests: Sequence[Request]) -> Dict[int, List[int]]: ...

    def retire(self, uid: int) -> List[int]: ...

    def cancel(self, uid: int) -> None: ...

    @property
    def has_work(self) -> bool: ...

    @property
    def clock(self) -> float: ...


def _retire(engine: Any, finished: Dict[int, List[int]], uid: int
            ) -> List[int]:
    """Both engines' ``retire``: drop a FINISHED or SHED request's handle,
    results entry and uid reservation; return its tokens (a SHED request's
    are whatever it streamed)."""
    handle = engine.handles.get(uid)
    if handle is None:
        raise KeyError(f"unknown uid {uid}")
    if not handle.done:
        raise RuntimeError(f"request {uid} is {handle.status.value}; "
                           "only FINISHED/SHED requests can be retired")
    tokens = finished.pop(uid, None)
    if tokens is None:
        tokens = list(handle.tokens)
    del engine.handles[uid]
    engine._seen_uids.discard(uid)
    return tokens


def _cancellable(engine: Any, uid: int, if_running: str) -> RequestHandle:
    """The handle of a request ``cancel`` may drop (not yet terminal, not
    RUNNING), else raise; ``if_running`` says why a running one cannot
    be."""
    handle = engine.handles.get(uid)
    if handle is None:
        raise KeyError(f"unknown uid {uid}")
    if handle.done:
        raise RuntimeError(f"request {uid} already {handle.status.value}")
    if handle.status is RequestStatus.RUNNING:
        raise RuntimeError(f"request {uid} is running; {if_running}")
    return handle


class ServeEngine(_DeferredErrors):
    """Continuous batching over ``max_batch`` persistent slots.

    Requests enter through ``submit`` any time (``run`` for the blocking
    form); freed slots are re-prefilled one by one against the shared
    cache arena while the other slots' caches stay untouched, and decoding
    runs ``decode_chunk`` steps per round.  With a ``PrecisionSchedule`` on
    the runtime, slots are tier-tagged and each chunk serves the occupied
    tiers together (``fused_decode``: one group-switching GEMM per
    projection, else the per-group reference loop), or one tier at a time
    with ``mixed_tiers=False``.  A schedule with ``kv_tiers`` gets the mixed
    per-slot KV arena (``kv_bits`` must then stay None).
    ``scheduler_policy`` picks which waiting request takes a freed slot.
    ``packed`` prepares unprepared params as the byte-packed store.
    ``spill_dir`` writes preempted slots' snapshots to disk instead of
    keeping them in host memory; ``telemetry`` takes the lifecycle and
    dispatch hooks; ``count_dispatches`` records each decode layout's
    kernel launches (``decode_dispatch_count``) in ``stats``.  Everything
    runs on ``device`` (default cuda); the params must live there.

    ``mesh`` (a ``launch.mesh.ServeMesh``) makes this engine one rank of a
    tensor-parallel group (see the module docstring): every rank of the
    mesh constructs it with the same arguments (the full params; each keeps
    its shard) and submits and steps the same requests in the same order.
    Its ``device`` is the mesh's."""

    def __init__(self, model: LM, params: Any, rt: Runtime, *,
                 max_batch: int = 8, max_len: int = 512,
                 kv_bits: Optional[int] = None, decode_chunk: int = 8,
                 prompt_bucket: int = 8, packed: bool = False,
                 mixed_tiers: bool = True, fused_decode: bool = True,
                 count_dispatches: bool = False,
                 scheduler_policy: Optional[SchedulerPolicy] = None,
                 mesh: Optional[Any] = None,
                 spill_dir: Optional[str] = None,
                 telemetry: Optional[Any] = None,
                 device: Any = None) -> None:
        if mesh is not None:
            if not mesh.member:
                raise ValueError("this rank is not on the mesh (a mesh of "
                                 f"{mesh.n} ranks takes the first {mesh.n})")
            if device is not None and \
                    resolve_device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.model = model
        self.rt = dataclasses.replace(rt, fused=fused_decode)
        self.count_dispatches = count_dispatches
        self.max_batch = max_batch
        self.max_len = max_len
        self.kv_bits = kv_bits
        self.decode_chunk = max(1, decode_chunk)
        self.prompt_bucket = max(1, prompt_bucket)
        self.mixed_tiers = mixed_tiers
        self.params = _ensure_prepared(params, rt, model, packed)
        self.quantized_paths = quantized_paths(self.params)
        self.schedule = rt.schedule
        # Tier-serialized mode: the tier the decode batch runs at (None
        # while it is empty) and the one it ran at last.
        self._active_tier: Optional[str] = None
        self._last_tier: Optional[str] = None
        arena_kv: Any = kv_bits
        self._mixed_kv = False
        if self.schedule is not None and self.schedule.kv_tiers is not None:
            if kv_bits is not None:
                raise ValueError(
                    "kv_bits conflicts with the schedule's kv_tiers (per-"
                    "request KV precision); drop one of the two")
            arena_kv = self.schedule.kv_modes
            self._mixed_kv = True
        self.arena = slots_lib.SlotArena(model, max_batch, max_len,
                                         kv_bits=arena_kv, device=self.device)
        # Tensor parallelism: shard the store and the arena, validated
        # before any dispatch; the runtime carries the TP context.
        self.mesh = mesh
        self._tp: Optional[tp_serve.TPConfig] = None
        if mesh is not None:
            self._tp = self._init_mesh_placement(mesh)
            self.rt = dataclasses.replace(self.rt, tp=self._tp)
        self.scheduler = Scheduler(max_batch, policy=scheduler_policy)
        self.stats = EngineStats()
        # Whether each new decode layout's launches are counted: taken from
        # the arguments every rank of a mesh receives alike, since the
        # count runs a decode step (collectives included) on every rank.
        self._count_layouts = count_dispatches or (
            telemetry is not None and telemetry.profiler is not None)
        if mesh is not None and mesh.rank != 0:
            telemetry = None                 # rank 0 records for the mesh
        # Every hook below is guarded by ``telemetry is not None``: without
        # it the engine takes no hook and makes no device sync.
        self.telemetry = telemetry
        if telemetry is not None:
            telemetry.attach_engine(
                num_slots=max_batch, schedule=self.schedule,
                mac_counts=model.cfg.quant_layer_macs()
                if self.schedule is not None else None)
        self._layout_cache: Dict[Tuple[Optional[str], ...],
                                 Tuple[GroupLayout, npt.NDArray[np.int64]]] = {}
        self.handles: Dict[int, RequestHandle] = {}
        self._seen_uids: Set[int] = set()
        # Preemption: uid -> snapshot of the suspended slot, spilled through
        # the checkpoint module when ``spill_dir`` is set.
        self._suspended: Dict[int, SuspendedState] = {}
        self._spill_dir = spill_dir
        self._spiller: Optional[checkpoint_lib.AsyncCheckpointer] = None
        self._spill_counter = 0
        self._in_round = False               # preempt() is illegal mid-round
        # Time slices: the tick each slot's current occupancy began.
        self._slice_start: Dict[int, float] = {}
        # Host-mirrored per-slot decode state.
        self._tok: npt.NDArray[np.int32] = np.zeros((max_batch,), np.int32)
        self._remaining: npt.NDArray[np.int32] = np.zeros((max_batch,),
                                                          np.int32)
        # Host-mirrored per-slot sampling state: raw request keys, draw
        # counters, temperature and top-k.  Greedy slots keep temperature
        # 0 and never advance their counter.
        self._key: npt.NDArray[np.uint32] = np.zeros((max_batch, 2),
                                                     np.uint32)
        self._draws: npt.NDArray[np.int32] = np.zeros((max_batch,), np.int32)
        self._temp: npt.NDArray[np.float32] = np.zeros((max_batch,),
                                                       np.float32)
        self._topk: npt.NDArray[np.int32] = np.zeros((max_batch,), np.int32)

    # --------------------------------------------------------------- mesh TP
    def _init_mesh_placement(self, mesh: Any) -> tp_serve.TPConfig:
        """Validate the mesh against the model, derive the TP context, and
        keep this rank's shard of the prepared store and of the arena.

        Every sharded weight is N-sharded on its last axis; the KV arena
        shards over KV heads when they divide, else (MQA ``num_kv_heads ==
        1``) stays replicated with only query heads sharded.  A
        non-dividing axis raises here, at construction."""
        n = mesh.n
        cfg = self.model.cfg
        if cfg.num_heads and cfg.num_heads % n != 0:
            raise ValueError(
                f"serve TP: num_heads={cfg.num_heads} does not divide "
                f"across {n} devices")
        kv_shards = bool(cfg.num_kv_heads) and cfg.num_kv_heads % n == 0
        if cfg.num_kv_heads and not kv_shards and cfg.num_kv_heads != 1:
            raise ValueError(
                f"serve TP: num_kv_heads={cfg.num_kv_heads} neither "
                f"divides across {n} devices nor is 1 (the replicated-MQA "
                "fallback)")
        if not _params_prepared(self.params):
            raise ValueError("serve TP shards the prepared plane store; a "
                             "mesh needs an integer backend")
        self._p_specs = sharding_rules.serve_tp_param_specs(
            self.params, n=n, kv_shards=kv_shards)
        self._c_specs = sharding_rules.serve_tp_cache_specs(
            self.arena.caches, n=n, kv_shards=kv_shards)
        self.params = sharding_rules.shard_tree(
            self.params, self._p_specs, n=n, rank=mesh.rank)
        self.arena.caches = sharding_rules.shard_tree(
            self.arena.caches, self._c_specs, n=n, rank=mesh.rank)
        return tp_serve.TPConfig(n=n, rank=mesh.rank, kv_shards=kv_shards,
                                 group=mesh.group)

    def _gather_shard(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """One arena field of a slot, whole: its KV-head shards gathered
        from every rank (a snapshot holds the unsharded engine's bytes)."""
        dim = self._c_specs[path]
        if dim is None:
            return t
        return comm.all_gather_tiled(t, dim, self._tp.group)

    def _keep_shard(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's KV-head slice of one whole arena field of a slot."""
        return sharding_rules.shard(t, self._c_specs[path], n=self._tp.n,
                                    rank=self.mesh.rank)

    def _shard_spilled(self, path: str, arr: np.ndarray) -> np.ndarray:
        """``checkpoint.restore``'s ``sharding_fn``: this rank's slice of
        one leaf of a spilled snapshot (stacked over the periods)."""
        dim = sharding_rules.serve_tp_cache_spec(
            path, arr, n=self._tp.n, kv_shards=self._tp.kv_shards)
        if dim is None:
            return arr
        return np.split(arr, self._tp.n, axis=dim)[self.mesh.rank]

    def _spill_target(self) -> Any:
        """The shapes and dtypes of a spilled snapshot: the unsharded
        engine's, whose bytes a mesh engine's spill files hold."""
        tmpl = slots_lib.spill_template(self.arena.caches)
        if self._tp is None:
            return tmpl
        for pos, fields in tmpl.items():
            for f, t in fields.items():
                dim = self._c_specs[f"0.{pos}.{f}"]
                if dim is not None:
                    shape = list(t.shape)
                    shape[dim + 1] *= self._tp.n      # + the period axis
                    fields[f] = torch.empty(shape, dtype=t.dtype,
                                            device="meta")
        return tmpl

    # ----------------------------------------------------- dispatch counting
    @torch.inference_mode()
    def decode_dispatch_count(self, *, groups: Optional[GroupLayout] = None,
                              tier: Optional[str] = None) -> int:
        """Kernel launches of ONE decode step at a group layout (``groups``)
        or one tier: the ``_build.LAUNCHES`` delta of a step run with every
        slot inactive, which writes no cache and emits nothing.  0 on the
        plain backend and on the CPU (no kernel launches there).

        On a mesh engine (every rank calls it: the step gathers) it is the
        unsharded graph's count, as in the reference: this rank's launches
        plus the act-quant launch the unsharded graph makes where each
        gathered projection quantizes with the shared range instead."""
        if groups is not None:
            rt = self.rt.for_groups(groups, torch.arange(
                self.max_batch, dtype=torch.int64, device=self.device))
        elif tier is not None:
            rt = self.rt.for_tier(tier)
        else:
            rt = self.rt
        before = self._launches()
        self.model.decode_step(
            self.params, rt, self.arena.caches,
            tokens=torch.from_numpy(self._tok[:, None]).to(self.device),
            active=torch.zeros((self.max_batch,), dtype=torch.bool,
                               device=self.device))
        return self._launches() - before

    def _launches(self) -> int:
        """Kernel launches so far, with a mesh engine's stand-in
        quantizations counted as the launches they replace."""
        n = sum(_build.LAUNCHES.values())
        if self._tp is not None:
            n += tp_serve.STANDIN_QUANTS["act_quant"]
        return n

    # ------------------------------------------------------------------ clock
    @property
    def clock(self) -> float:
        """Deterministic scheduler clock: decode steps executed so far."""
        return float(self.stats.decode_steps)

    @property
    def has_work(self) -> bool:
        """True while anything waits or decodes."""
        return self.scheduler.has_work

    def _sync_telemetry(self) -> None:
        """Mirror EngineStats into the telemetry registry (after every
        state-changing operation, so the twins always agree)."""
        if self.telemetry is not None:
            self.telemetry.sync_stats(
                self.stats, queue_depth=len(self.scheduler.waiting))

    # ----------------------------------------------------------------- intake
    def submit(self, request: Request) -> RequestHandle:
        """Queue one request; returns its streaming :class:`RequestHandle`.
        On a tiered engine the queued copy carries a concrete tier name.
        Under ``SLOPolicy(shed=True)`` the policy's admission decision runs
        here: a deadlined request that would miss comes back SHED, or (with
        ``auto_tier``) downtiered to the best tier that fits."""
        _validate_request(request, self.max_len, self._seen_uids)
        if self.schedule is None:
            if request.tier is not None:
                raise ValueError(
                    f"request {request.uid}: tier {request.tier!r} on an "
                    "engine without a PrecisionSchedule")
            request = dataclasses.replace(request)
        else:
            if request.tier is not None \
                    and request.tier not in self.schedule.tiers:
                raise ValueError(
                    f"request {request.uid}: unknown tier {request.tier!r}; "
                    f"engine serves {sorted(self.schedule.tiers)}")
            request = dataclasses.replace(
                request, tier=request.tier or self.schedule.default_tier)
        if request.sampling is not None:
            request.sampling.validate()
        if request.spec is not None:
            request.spec.validate()
            if self.schedule is None:
                raise ValueError(
                    f"request {request.uid}: speculative decoding needs an "
                    "engine with a PrecisionSchedule (the draft tier is a "
                    "plane prefix of the superplane store)")
            if request.spec.draft_tier not in self.schedule.tiers:
                raise ValueError(
                    f"request {request.uid}: unknown draft tier "
                    f"{request.spec.draft_tier!r}; engine serves "
                    f"{sorted(self.schedule.tiers)}")
            if not self.mixed_tiers:
                raise ValueError(
                    f"request {request.uid}: speculative decoding needs "
                    "mixed_tiers=True (draft rows are retagged in the "
                    "decode group layout)")
            if self.mesh is not None:
                raise ValueError(
                    f"request {request.uid}: speculative decoding is not "
                    "supported on a mesh engine; submit without spec or "
                    "use an unsharded engine")
        self._seen_uids.add(request.uid)
        # Handle and scheduler share the SAME (normalized) Request, so a
        # QUEUED set_tier re-tags the queue entry in place.
        handle = RequestHandle(request, self, submitted_at=self.clock)
        self.handles[request.uid] = handle
        pol = self.scheduler.policy
        if isinstance(pol, SLOPolicy) and pol.shed:
            decision = pol.admission_decision(
                request, list(self.scheduler.waiting), self._running_info(),
                self.max_batch, self.scheduler.submitted_at, self.clock)
            if decision == "shed":
                handle._mark_shed(self.clock)
                self.stats.sheds += 1
                if self.telemetry is not None:
                    self.telemetry.on_submit(handle, ticks=self.clock)
                    self.telemetry.on_shed(handle, ticks=self.clock)
                self._sync_telemetry()
                return handle
            if decision != "admit":
                request.tier = decision          # the normalized copy
                self.stats.tier_autoselects += 1
        self.scheduler.submit(request, now=self.clock)
        if self.telemetry is not None:
            self.telemetry.on_submit(handle, ticks=self.clock)
        self._sync_telemetry()
        return handle

    # -------------------------------------------------------------- migration
    def _set_tier(self, handle: RequestHandle, tier: str) -> None:
        """Move one request to another tier (``RequestHandle.set_tier``).

        QUEUED: re-tag the waiting request (it prefills at the new tier).
        RUNNING (mixed-tier mode only): requantize the slot's KV lanes in
        place if the two tiers' KV codes differ, then re-tag the slot; the
        weight plane prefix switches at the next group layout.  A SUSPENDED
        request (its snapshot holds its tier's KV codes) and a finished one
        raise."""
        if self.schedule is None:
            raise ValueError("set_tier needs an engine with a "
                             "PrecisionSchedule")
        if tier not in self.schedule.tiers:
            raise ValueError(f"unknown tier {tier!r}; engine serves "
                             f"{sorted(self.schedule.tiers)}")
        if handle.done:
            raise RuntimeError(
                f"request {handle.uid} already {handle.status.value}; "
                "cannot migrate its tier")
        old = handle.request.tier
        if tier == old:
            return
        if handle.status is RequestStatus.SUSPENDED:
            raise RuntimeError(
                f"request {handle.uid} is suspended; its KV snapshot is "
                "pinned at its tier — let it resume (or cancel it) first")
        if handle.status is RequestStatus.QUEUED:
            handle.request.tier = tier      # shared with the queue entry
            return
        if not self.mixed_tiers:
            raise RuntimeError(
                "mid-stream tier migration needs mixed_tiers=True (a "
                "serialized decode batch runs one tier at a time)")
        slot = handle.slot
        assert slot is not None
        kv_migrated = False
        tele = self.telemetry
        t0 = tele.dispatch_start(self.device) if tele is not None else 0.0
        if self._mixed_kv:
            code = self.schedule.kv_code_for(tier)
            if code != self.schedule.kv_code_for(old):
                with torch.inference_mode():
                    slots_lib.migrate_kv_tier(self.arena.caches, slot, code)
                self.stats.kv_migrations += 1
                kv_migrated = True
        handle.request.tier = tier          # shared with the SlotState
        self.arena.tiers[slot] = tier
        self.stats.tier_migrations += 1
        if tele is not None:
            tele.on_migrate(
                uid=handle.uid, old_tier=old, new_tier=tier, kv=kv_migrated,
                ticks=self.clock, t0=t0 if kv_migrated else None,
                fence=self.device if kv_migrated else None)
        self._sync_telemetry()

    # ------------------------------------------------------------- preemption
    @property
    def suspended(self) -> Dict[int, SuspendedState]:
        """The live suspensions (uid -> snapshot), as a copy."""
        return dict(self._suspended)

    def _running_info(self) -> List[RunningEntry]:
        """The RUNNING slots as the overload hooks price them: (slot,
        request, decode tokens still owed, submission tick)."""
        return [(slot, s.request, int(s.remaining),
                 self.handles[s.uid].submitted_at)
                for slot, s in self.scheduler.occupied()]

    def preempt(self, uid: int) -> SuspendedState:
        """Suspend a RUNNING request, freeing its slot.

        The slot's cache is copied to the host (``slots.slot_snapshot``: a
        copy, not a view, finished before this returns) with the host
        decode state (tokens, budget owed, last token, draw counter) as a
        :class:`SuspendedState`; with ``spill_dir`` it goes to disk.  The
        request waits again at its ORIGINAL submission tick (a preemption
        never extends its deadline) and its handle turns SUSPENDED; it
        resumes prefill-free in whichever slot frees, token-identical.

        Legal only between scheduling rounds: from inside ``step()`` (an
        ``on_token`` callback) it raises, since the device state there is
        ahead of the host's token bookkeeping."""
        if self._in_round:
            raise RuntimeError(
                "preempt() called from inside a scheduling round (e.g. an "
                "on_token callback); preemption is only legal between "
                "engine.step() calls")
        handle = self.handles.get(uid)
        if handle is None:
            raise KeyError(f"unknown uid {uid}")
        if handle.status is not RequestStatus.RUNNING:
            raise RuntimeError(
                f"request {uid} is {handle.status.value}; only RUNNING "
                "requests can be preempted")
        slot = handle.slot
        assert slot is not None
        state = self.scheduler.evict(slot)
        cache = slots_lib.slot_snapshot(
            self.arena.caches, slot,
            gather=self._gather_shard if self.mesh is not None else None)
        sus = SuspendedState(
            request=state.request, tokens=list(state.tokens),
            remaining=int(state.remaining), last_token=int(self._tok[slot]),
            cache=cache, nbytes=slots_lib.snapshot_nbytes(cache),
            draws=int(self._draws[slot]))
        if self._spill_dir is not None:
            sus = self._spill(sus)
        self._suspended[uid] = sus
        self.arena.tiers[slot] = None
        handle._mark_suspended()
        pol = self.scheduler.policy
        if isinstance(pol, SLOPolicy):
            # A half-served stream owes only its remainder.
            pol.remaining_tokens[uid] = sus.remaining
        self.scheduler.submit(state.request, now=handle.submitted_at)
        self.stats.preemptions += 1
        if self.telemetry is not None:
            self.telemetry.on_suspend(handle, ticks=self.clock)
        self._sync_telemetry()
        return sus

    def _policy_preempt(self) -> None:
        """``SLOPolicy(preempt=True)`` between rounds: while more deadlined
        requests are out of slack than slots are free, and the policy names
        a strictly slacker RUNNING victim, suspend it (each victim waits
        with more slack than the request it yielded to, so this ends)."""
        pol = self.scheduler.policy
        if not isinstance(pol, SLOPolicy) or not pol.preempt:
            return
        for _ in range(self.max_batch):
            waiting = list(self.scheduler.waiting)
            urgent = [r for r in waiting if r.deadline is not None
                      and pol.weighted_slack(r, self.scheduler.submitted_at,
                                             self.clock) <= pol.preempt_slack]
            if len(self.scheduler.free_slots()) >= len(urgent):
                return
            victim = pol.preempt_victim(
                waiting, self._running_info(), self.scheduler.submitted_at,
                self.clock)
            if victim is None:
                return
            self.preempt(victim)

    def _time_slice_preempt(self) -> None:
        """``SLOPolicy(time_slice=N)`` between rounds: preempt best-effort
        (deadline-free) RUNNING slots whose slice has run N ticks while
        requests wait, the oldest slice first and no more than wait.  A
        victim is re-aged as submitted NOW in the scheduler only (its
        handle keeps its submission tick), so the requests it yields to
        win the tie-break."""
        pol = self.scheduler.policy
        if not isinstance(pol, SLOPolicy) or pol.time_slice is None:
            return
        n_waiting = len(self.scheduler.waiting)
        if n_waiting == 0:
            return
        expired = [(self._slice_start.get(slot, self.clock), state.uid)
                   for slot, state in self.scheduler.occupied()
                   if state.request.deadline is None
                   and self.clock - self._slice_start.get(slot, self.clock)
                   >= pol.time_slice]
        expired.sort()                     # the oldest slice first
        for _, uid in expired[:n_waiting]:
            self.preempt(uid)
            self.scheduler.submitted_at[uid] = self.clock
            self.stats.time_slice_preemptions += 1

    @torch.inference_mode()
    def _resume_into(self, slot: int, req: Request,
                     sus: SuspendedState) -> None:
        """Prefill-free re-admission: write the snapshot into the (possibly
        different) slot and restore the host decode state where the
        preemption cut it."""
        if sus.cache is not None:      # whole: keep this rank's slice
            slots_lib.slot_restore(
                self.arena.caches, sus.cache, slot,
                scatter=self._keep_shard if self.mesh is not None else None)
        else:                          # read back as this rank's slice
            slots_lib.slot_restore(self.arena.caches, self._unspill(sus),
                                   slot)
        self.arena.tiers[slot] = req.tier
        state = self.scheduler.slots[slot]
        assert state is not None
        state.tokens = list(sus.tokens)
        state.remaining = sus.remaining
        self._tok[slot] = sus.last_token
        self._remaining[slot] = sus.remaining
        self._load_sampling_state(slot, req, draws=sus.draws)
        self._slice_start[slot] = self.clock
        pol = self.scheduler.policy
        if isinstance(pol, SLOPolicy):
            pol.remaining_tokens.pop(req.uid, None)
        self.handles[req.uid]._mark_admitted(slot, self.clock)
        self.stats.resumes += 1
        if self.telemetry is not None:
            self.telemetry.on_admit(self.handles[req.uid], slot=slot,
                                    ticks=self.clock, resumed=True)

    def _spill(self, sus: SuspendedState) -> SuspendedState:
        """Write a snapshot through the checkpoint module, in the
        reference's layout (``slots.spill_tree``: either package restores
        it), and drop it from host memory.  ``keep=0``: live spills are never collected;
        :meth:`_unspill` removes each step dir as its request resumes.  On a
        mesh, rank 0 writes (its snapshot is the whole one every rank
        holds) and every rank reads."""
        assert self._spill_dir is not None
        step = self._spill_counter
        self._spill_counter += 1
        if self.mesh is None or self.mesh.rank == 0:
            if self._spiller is None:
                self._spiller = checkpoint_lib.AsyncCheckpointer(
                    self._spill_dir, keep=0)
            self._spiller.save(step, slots_lib.spill_tree(sus.cache), extra={
                "uid": sus.request.uid, "tokens": sus.tokens,
                "remaining": sus.remaining, "last_token": sus.last_token,
                "tier": sus.request.tier})
        self.stats.spill_bytes += sus.nbytes
        return dataclasses.replace(sus, cache=None, spill_step=step)

    def _unspill(self, sus: SuspendedState) -> Any:
        """Read a spilled snapshot back (waiting for the writer) and delete
        its step dir.  On a mesh every rank reads its own slice of the
        file rank 0 wrote (``checkpoint.restore``'s ``sharding_fn``),
        between barriers."""
        assert sus.spill_step is not None and self._spill_dir is not None
        if self._spiller is not None:
            self._spiller.wait()
        if self.mesh is not None:
            self.mesh.barrier()              # the file is complete
        tree, _ = checkpoint_lib.restore(
            self._spill_dir, sus.spill_step, target=self._spill_target(),
            device="cpu",
            sharding_fn=self._shard_spilled if self.mesh is not None
            else None)
        if self.mesh is not None:
            self.mesh.barrier()              # every rank has read it
        if self._spiller is not None:
            checkpoint_lib.remove(self._spill_dir, sus.spill_step)
        return slots_lib.unspill_tree(tree)

    def _drop_suspended(self, uid: int) -> None:
        """Discard a suspension's snapshot (its spill dir too) and its
        policy entry."""
        sus = self._suspended.pop(uid, None)
        if sus is not None and sus.spill_step is not None \
                and self._spiller is not None:   # the writing rank
            assert self._spill_dir is not None
            self._spiller.wait()
            checkpoint_lib.remove(self._spill_dir, sus.spill_step)
        pol = self.scheduler.policy
        if isinstance(pol, SLOPolicy):
            pol.remaining_tokens.pop(uid, None)

    def cancel(self, uid: int) -> None:
        """Drop a QUEUED or SUSPENDED request: its queue entry, submission
        clock, snapshot and spill dir go, and its handle turns SHED with
        whatever it streamed.  A RUNNING request must be preempted first."""
        handle = _cancellable(self, uid, "preempt it first (cancel takes "
                              "only QUEUED or SUSPENDED requests)")
        self.scheduler.cancel(uid)
        self._drop_suspended(uid)
        handle._mark_shed(self.clock)
        self.stats.sheds += 1
        if self.telemetry is not None:
            self.telemetry.on_shed(handle, ticks=self.clock)
        self._sync_telemetry()

    def retire(self, uid: int) -> List[int]:
        """Drop a terminal (FINISHED or SHED) request's handle, results
        entry, uid reservation and any suspension left behind, and return
        its tokens: a long-running server's bound on per-request host
        memory.  The uid may be submitted again."""
        tokens = _retire(self, self.scheduler.finished, uid)
        self._drop_suspended(uid)
        return tokens

    # ------------------------------------------------------------- scheduling
    def _bucket_pad(self, prompt: npt.NDArray[np.int32]
                    ) -> Tuple[npt.NDArray[np.int32], int]:
        """Right-pad to the next bucket multiple."""
        plen = len(prompt)
        bucket = -(-plen // self.prompt_bucket) * self.prompt_bucket
        bucket = min(bucket, self.max_len)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :plen] = prompt
        return padded, plen

    def _emit_token(self, state: Any, token: int, tier: Optional[str],
                    speculative: bool = False) -> TokenEvent:
        """Record one emitted token on slot state + handle.  ``speculative``
        marks tokens of a speculative round (accepted drafts and
        corrections, all verified at ``tier``).  A callback that raises is
        re-raised at the end of the round (``_raise_deferred``)."""
        index = len(state.tokens)
        state.emit(token)
        sp = state.request.sampling
        event = TokenEvent(uid=state.uid, token=token, index=index,
                           tier=tier, final=state.done,
                           sampled=sp is not None and sp.temperature > 0.0,
                           speculative=speculative)
        self.handles[state.uid]._push(event, self.clock,
                                      defer=self._defer_error)
        if self.telemetry is not None:
            self.telemetry.on_token(event, ticks=self.clock)
        return event

    def _load_sampling_state(self, slot: int, req: Request, *,
                             draws: int) -> None:
        """Load one slot's sampling state from its request: the raw request
        key, the draw counter (0 at admission, the snapshot's at resume),
        temperature and top-k.  Greedy requests keep the all-zero state and
        never consume randomness."""
        sp = req.sampling
        self._key[slot] = sampling_lib.request_key(sp.seed if sp else 0)
        self._temp[slot] = np.float32(sp.temperature if sp else 0.0)
        self._topk[slot] = sp.top_k if sp else 0
        self._draws[slot] = draws

    def _sampling_args(self, slots: Any = slice(None)
                       ) -> Tuple[torch.Tensor, ...]:
        """The sampling state of ``slots`` on the device: (keys int64
        [B, 2], draws int32 [B], temperature f32 [B], top-k int32 [B])."""
        dev = self.device
        return (torch.from_numpy(self._key[slots].astype(np.int64)).to(dev),
                torch.from_numpy(self._draws[slots]).to(dev),
                torch.from_numpy(self._temp[slots]).to(dev),
                torch.from_numpy(self._topk[slots]).to(dev))

    @staticmethod
    def _select(logits: torch.Tensor, keys: torch.Tensor, draws: torch.Tensor,
                temp: torch.Tensor, topk: torch.Tensor, sampled: bool,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``sample_tokens`` over logits [B, V]; ``sampled`` False (no row
        at temperature > 0, known on the host) takes the raw-logits argmax
        alone, which is what ``sample_tokens`` returns for such a batch."""
        if not sampled:
            return torch.argmax(logits, dim=-1).to(torch.int32), draws
        return sampling_lib.sample_tokens(logits, keys, draws, temp, topk,
                                          active=active)

    @torch.inference_mode()
    def _prefill_slot(self, slot: int, padded: npt.NDArray[np.int32],
                      plen: int, tier: Optional[str]) -> int:
        """Reset one slot (and in the mixed KV arena set its tier code),
        prefill its right-padded prompt through a view of the arena
        (written in place), return the first token: draw event 0 of the
        slot's sampling state."""
        caches = slots_lib.slot_reset(self.arena.caches, slot)
        sub = slots_lib.slot_view(caches, slot)
        if self._mixed_kv:
            slots_lib.fill_kv_tier(sub, self.schedule.kv_code_for(tier))
        tokens = torch.from_numpy(padded).to(self.device)
        lengths = torch.tensor([plen], dtype=torch.int32, device=self.device)
        logits, _ = self.model.prefill(self.params, self.rt.for_tier(tier),
                                       sub, tokens=tokens,
                                       seq_lengths=lengths)
        tok, _ = self._select(logits[:, -1],
                              *self._sampling_args(slice(slot, slot + 1)),
                              sampled=bool(self._temp[slot] > 0.0))
        return int(tok[0])

    def _admit_free_slots(self) -> List[TokenEvent]:
        """Fill free slots from the waiting queue (mixed-tier mode: the
        policy's pick into any slot; serialized mode: only requests of the
        batch's tier, the next tier chosen by the policy's pick when the
        batch is empty) and prefill each admitted request; returns the
        prefill-emitted first tokens as events.  A SUSPENDED request that
        wins a slot resumes instead (:meth:`_resume_into`: no prefill, no
        event)."""
        events: List[TokenEvent] = []
        for slot in self.scheduler.free_slots():
            if self.schedule is None or self.mixed_tiers:
                req = self.scheduler.admit(slot, now=self.clock)
            else:
                if self._active_tier is None:
                    pick = self.scheduler.peek(now=self.clock)
                    if pick is None:
                        break
                    if self.stats.decode_chunks:
                        self.stats.tier_switches += \
                            pick.tier != self._last_tier
                    self._active_tier = pick.tier
                req = self.scheduler.admit(slot, tier=self._active_tier,
                                           now=self.clock)
            if req is None:
                break
            sus = self._suspended.pop(req.uid, None)
            if sus is not None:
                self._resume_into(slot, req, sus)
                continue
            self._auto_select_tier(req)
            padded, plen = self._bucket_pad(np.asarray(req.prompt))
            self._load_sampling_state(slot, req, draws=0)
            tele = self.telemetry
            t1 = tele.dispatch_start(self.device) if tele is not None else 0.0
            t0 = time.perf_counter()
            first = self._prefill_slot(slot, padded, plen, req.tier)
            self.stats.prefill_seconds += time.perf_counter() - t0
            self.arena.tiers[slot] = req.tier
            self.stats.prefills += 1
            self.stats.prefill_tokens += plen
            if tele is not None:
                tele.on_prefill(uid=req.uid, tier=req.tier, prompt_len=plen,
                                t0=t1, ticks=self.clock, fence=self.device)
            # The first token was draw event 0 (sampled rows only).
            if self._temp[slot] > 0.0:
                self._draws[slot] = 1
            self._slice_start[slot] = self.clock
            state = self.scheduler.slots[slot]
            assert state is not None
            self.handles[req.uid]._mark_admitted(slot, self.clock)
            if tele is not None:
                tele.on_admit(self.handles[req.uid], slot=slot,
                              ticks=self.clock)
            events.append(self._emit_token(state, first, req.tier))
            self._tok[slot] = first
            self._remaining[slot] = state.remaining
        return events

    def _auto_select_tier(self, req: Request) -> None:
        """``SLOPolicy(auto_tier=True)``, mixed-tier mode: retag the
        just-admitted deadlined request to the tier ``select_tier`` picks,
        before its slot prefills, so the new tier sets its prefill, its
        weight plane prefix and its KV precision."""
        pol = self.scheduler.policy
        if (self.schedule is None or not self.mixed_tiers
                or not isinstance(pol, SLOPolicy) or not pol.auto_tier):
            return
        tier = pol.select_tier(req, self.handles[req.uid].submitted_at,
                               self.clock)
        if tier is not None and tier != req.tier \
                and tier in self.schedule.tiers:
            req.tier = tier          # shared with the handle
            self.stats.tier_autoselects += 1

    def _release_done(self) -> None:
        """Release exhausted slots and clear their arena tier tags."""
        for slot in self.scheduler.release_done():
            self.arena.tiers[slot] = None

    def _group_layout(self, tiers: Optional[Sequence[Optional[str]]] = None
                      ) -> Tuple[GroupLayout, npt.NDArray[np.int64]]:
        """The per-step mixed-tier layout from the slot tier tags:
        ``(groups, perm)`` with groups in schedule tier order (free slots
        ride in the default tier's group; their lanes are masked) and
        ``perm`` the slot order realizing it.  ``tiers`` overrides the
        arena's tier vector: the speculative draft phase passes a copy with
        the spec slots re-tagged to their draft tiers.  Memoized on the
        slot-tier vector (``layout_cache_hits`` / ``layout_cache_misses``)."""
        schedule = self.schedule
        assert schedule is not None
        cache_key = tuple(self.arena.tiers if tiers is None else tiers)
        cached = self._layout_cache.get(cache_key)
        if cached is not None:
            self.stats.layout_cache_hits += 1
            return cached
        self.stats.layout_cache_misses += 1
        rank = {t: i for i, t in enumerate(schedule.tier_names)}
        default = schedule.default_tier
        slot_tiers = [t if t is not None else default for t in cache_key]
        order = sorted(range(self.max_batch),
                       key=lambda s: (rank[slot_tiers[s]], s))
        groups: List[List[Any]] = []
        for s in order:
            t = slot_tiers[s]
            if groups and groups[-1][0] == t:
                groups[-1][1] += 1
            else:
                groups.append([t, 1])
        layout = (tuple((t, n) for t, n in groups),
                  np.asarray(order, np.int64))
        self._layout_cache[cache_key] = layout
        return layout

    def _runtime(self, tiers: Optional[Sequence[Optional[str]]] = None
                 ) -> Runtime:
        """The decode runtime: the group layout of ``tiers`` (default: the
        arena's) on a mixed-tier engine, the batch's one tier on a
        serialized one, else the engine's runtime."""
        if self.schedule is None:
            return self.rt
        if not self.mixed_tiers:
            return self.rt.for_tier(self._active_tier)
        groups, perm = self._group_layout(tiers)
        return self.rt.for_groups(groups,
                                  torch.from_numpy(perm).to(self.device))

    @torch.inference_mode()
    def _decode_chunk(self, rt: Runtime, n_steps: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
        """``n_steps`` decode steps with an active-slot mask: a slot whose
        budget hits zero stops writing its cache THAT step; inactive rows
        hold their token and their draw counter.  Returns host copies (one
        transfer) of tok [B], remaining [B], draws [B] and the per-step
        tokens / actives [n_steps, B]."""
        dev = self.device
        tok = torch.from_numpy(self._tok).to(dev)
        remaining = torch.from_numpy(self._remaining).to(dev)
        keys, draws, temp, topk = self._sampling_args()
        sampled = bool((self._temp > 0.0).any())
        rows = []
        for _ in range(n_steps):
            active = remaining > 0
            logits, _ = self.model.decode_step(
                self.params, rt, self.arena.caches, tokens=tok[:, None],
                active=active)
            nxt, draws = self._select(logits[:, -1], keys, draws, temp, topk,
                                      sampled, active)
            tok = torch.where(active, nxt, tok)
            remaining = remaining - active.to(torch.int32)
            rows += [tok, active.to(torch.int32)]
        host = torch.stack(rows + [tok, remaining, draws]).cpu().numpy()
        toks = host[0:2 * n_steps:2]
        actives = host[1:2 * n_steps:2].astype(bool)
        return (host[-3].copy(), host[-2].copy(), host[-1].copy(), toks,
                actives)

    def step(self) -> List[TokenEvent]:
        """One scheduling round: admit into free slots, run one decode chunk
        (or one speculative round, when an occupied slot's request sets
        ``spec``) over the occupied slots, and account its tokens.  Returns
        every token emitted this round in emission order.

        The time-slice and ``SLOPolicy(preempt=True)`` displacement rules
        run first, between rounds (the only point where a snapshot is
        coherent), so the slots they free are filled by this round's
        admission; ``preempt`` is then refused until the round ends."""
        if self.schedule is not None and not self.mixed_tiers \
                and not self.scheduler.occupied():
            if self._active_tier is not None:     # the batch drained
                self._last_tier = self._active_tier
            self._active_tier = None
        self._time_slice_preempt()
        self._policy_preempt()
        self._in_round = True
        try:
            return self._step_round()
        finally:
            self._in_round = False
            self._sync_telemetry()

    def _step_round(self) -> List[TokenEvent]:
        """The round body of :meth:`step`: admit, decode, account."""
        events = self._admit_free_slots()
        self._release_done()                       # max_new_tokens == 1 cases
        occupied = self.scheduler.occupied()
        if not occupied:
            self._raise_deferred()
            return events
        if any(s.request.spec is not None for _, s in occupied):
            return self._spec_dispatch(occupied, events)
        # Trim the chunk so a tail of all-finished steps is never run.
        n_steps = int(min(self.decode_chunk,
                          max(s.remaining for _, s in occupied)))
        rt = self._runtime()
        tele = self.telemetry
        groups: Optional[GroupLayout] = rt.groups if (
            self.schedule is not None and self.mixed_tiers) else None
        if groups is not None:
            if self._count_layouts \
                    and groups not in self.stats.decode_dispatches:
                self.stats.decode_dispatches[groups] = \
                    self.decode_dispatch_count(groups=groups)
        t1 = tele.dispatch_start(self.device) if tele is not None else 0.0
        ticks0 = self.clock
        t0 = time.perf_counter()
        (self._tok, self._remaining, self._draws, toks,
         actives) = self._decode_chunk(rt, n_steps)
        self.stats.decode_seconds += time.perf_counter() - t0
        self.stats.decode_chunks += 1
        self.stats.decode_steps += n_steps
        self.stats.decode_slot_steps += int(actives.sum())
        self.stats.decode_idle_slot_steps += int((~actives).sum())
        if self.schedule is not None:
            # Serialized mode tags every slot with the batch's tier too.
            occupied_tiers = {self.arena.tiers[slot] for slot, _ in occupied}
            self.stats.mixed_tier_chunks += len(occupied_tiers) > 1
            by_tier = self.stats.decode_steps_by_tier
            for t in occupied_tiers:
                assert t is not None
                by_tier[t] = by_tier.get(t, 0) + n_steps
            tk = self.stats.tokens_by_tier
            for slot, _ in occupied:
                t = self.arena.tiers[slot]
                assert t is not None
                tk[t] = tk.get(t, 0) + int(actives[:, slot].sum())
        if tele is not None:
            # Free lanes carry tier None (priced at the schedule default).
            lanes = [(self.arena.tiers[s], int(actives[:, s].sum()))
                     for s in range(self.max_batch)]
            tele.on_decode_chunk(
                t0=t1, ticks0=ticks0, ticks_end=self.clock, n_steps=n_steps,
                lanes=lanes, groups=groups, fence=self.device,
                dispatches=self.stats.decode_dispatches.get(groups)
                if groups is not None else None)
        etier = {s_: self.arena.tiers[s_] for s_, _ in occupied}
        for s in range(n_steps):
            for slot, state in occupied:
                if actives[s, slot]:
                    events.append(self._emit_token(state, int(toks[s, slot]),
                                                   etier[slot]))
        self._release_done()
        self._raise_deferred()
        return events

    @torch.inference_mode()
    def _spec_round(self, k: int, rt_draft: Runtime, rt_verify: Runtime,
                    spec_mask: torch.Tensor, sampled: bool
                    ) -> Tuple[np.ndarray, ...]:
        """One speculative round on the device (the reference's
        ``spec_round_fn``), the arena written in place.

        Draft: k chained decode steps at ``rt_draft``; spec slots
        (``spec_mask``) draft without spending budget, plain slots take
        ordinary decode steps.  Rollback: the spec slots' lengths go back
        to their pre-draft values and their SSM rows to a device copy
        taken before the draft (``slots.merge_slots``).  Verify: the
        window ``[t0, d1..dk]`` through ONE ``verify_step`` at
        ``rt_verify``, writing spec slots only.  Then acceptance against
        the verify distributions, ``e = min(m+1, remaining)`` emitted
        tokens, the rejected positions' lengths rewound, each spec slot's
        SSM rows set to the verify's step ``e - 1`` and the draw counters
        of sampled spec slots advanced by ``k + 1``.  Returns host
        copies of tok, remaining, draws [B], the draft tokens and plain
        actives [k, B], the emission window [B, k+1], e and m [B]."""
        dev = self.device
        caches = self.arena.caches
        keys, draws, temp, topk = self._sampling_args()
        tok = torch.from_numpy(self._tok).to(dev)
        remaining = torch.from_numpy(self._remaining).to(dev)
        tok0 = tok
        saved = slots_lib.pre_draft_state(caches, spec_mask)
        dtoks, dact, qps = [], [], []
        for _ in range(k):
            active = remaining > 0
            plain_active = active & ~spec_mask
            logits, _ = self.model.decode_step(
                self.params, rt_draft, caches, tokens=tok[:, None],
                active=active)
            row = logits[:, -1]
            qps.append(self._probs(row, temp, topk, sampled))
            nxt, draws = self._select(row, keys, draws, temp, topk, sampled,
                                      active)
            tok = torch.where(active, nxt, tok)
            # Spec slots spend their budget at emission (verify) time.
            remaining = remaining - plain_active.to(torch.int32)
            dtoks.append(tok)
            dact.append(plain_active)
        slots_lib.merge_slots(caches, saved, spec_mask)
        drafts = torch.stack(dtoks, dim=1)                     # [B, k]
        window = torch.cat([tok0[:, None], drafts], dim=1)     # [B, k+1]
        vlogits, verified = self.model.verify_step(
            self.params, rt_verify, caches, tokens=window, active=spec_mask)
        batch, width = window.shape
        p = self._probs(vlogits.reshape(batch * width, -1),
                        temp.repeat_interleave(width),
                        topk.repeat_interleave(width),
                        sampled).reshape(batch, width, -1)
        q = torch.stack(qps, dim=1)                            # [B, k, V]
        m = spec_lib.accept_counts(drafts, q, p, keys, draws)
        corr = spec_lib.correction_tokens(q, p, m, keys, draws)
        emit = spec_lib.emission_window(drafts, corr, m)
        e = torch.where(spec_mask, torch.minimum(m + 1, remaining),
                        torch.zeros_like(m))
        last_idx = torch.clamp(e - 1, 0, width - 1)
        slots_lib.truncate_kv_lengths(caches, width - e, spec_mask)
        slots_lib.select_verify_step(caches, verified, last_idx)
        del verified
        last = emit.gather(1, last_idx[:, None].to(torch.int64))[:, 0]
        tok = torch.where(spec_mask, last, tok)
        remaining = remaining - e
        spec_sampled = spec_mask & (temp > 0.0)
        draws = draws + torch.where(
            spec_sampled, spec_lib.accept_draw_events(k), 0).to(draws.dtype)
        host = [t.cpu().numpy() for t in (
            torch.stack([tok, remaining, draws, e, m]),
            torch.stack(dtoks + [d.to(torch.int32) for d in dact]), emit)]
        vec, draft_rows, emit_h = host
        return (vec[0].copy(), vec[1].copy(), vec[2].copy(), draft_rows[:k],
                draft_rows[k:].astype(bool), emit_h, vec[3], vec[4])

    @staticmethod
    def _probs(logits: torch.Tensor, temp: torch.Tensor, topk: torch.Tensor,
               sampled: bool) -> torch.Tensor:
        """``sampling_probs``; with no sampled row in the batch (known on
        the host) every row is the argmax point mass it returns."""
        if sampled:
            return sampling_lib.sampling_probs(logits, temp, topk)
        return torch.nn.functional.one_hot(
            torch.argmax(logits, dim=-1), logits.shape[-1]).to(torch.float32)

    def _spec_dispatch(self, occupied: List[Tuple[int, Any]],
                       events: List[TokenEvent]) -> List[TokenEvent]:
        """One speculative scheduling round: derive the draft layout (spec
        slots re-tagged to their draft tiers: no weight is prepared again,
        the draft model is a plane prefix of the store), run the round,
        then emit — plain slots' draft-phase tokens step-major first, then
        each spec slot's accepted window with ``speculative=True``.  The
        clock advances k+1 steps.  Slots with different ``k`` share the
        round at the largest."""
        spec_states = [(slot, s) for slot, s in occupied
                       if s.request.spec is not None]
        k = max(s.request.spec.k for _, s in spec_states)
        width = k + 1
        spec_np = np.zeros((self.max_batch,), bool)
        draft_tiers = list(self.arena.tiers)
        for slot, s in spec_states:
            spec_np[slot] = True
            draft_tiers[slot] = s.request.spec.draft_tier
        rt_draft = self._runtime(draft_tiers)
        rt_verify = self._runtime()
        sampled = bool((self._temp > 0.0).any())
        tele = self.telemetry
        t1 = tele.dispatch_start(self.device) if tele is not None else 0.0
        ticks0 = self.clock
        t0 = time.perf_counter()
        (self._tok, self._remaining, self._draws, dtoks, dact, win, e,
         m) = self._spec_round(k, rt_draft, rt_verify,
                               torch.from_numpy(spec_np).to(self.device),
                               sampled)
        self.stats.decode_seconds += time.perf_counter() - t0
        n_spec = len(spec_states)
        st = self.stats
        st.decode_chunks += 1
        st.decode_steps += width
        st.spec_rounds += 1
        st.spec_draft_steps += k
        st.spec_verify_steps += 1
        st.spec_drafted += k * n_spec
        st.spec_accepted += int(np.minimum(m[spec_np], e[spec_np]).sum())
        st.spec_emitted += int(e[spec_np].sum())
        # Spec slots are busy all k+1 steps, plain slots their active
        # draft steps.
        busy = int(dact.sum()) + width * n_spec
        st.decode_slot_steps += busy
        st.decode_idle_slot_steps += width * self.max_batch - busy
        by_tier = st.decode_steps_by_tier
        draft_occ = {draft_tiers[slot] for slot, _ in occupied}
        verify_occ = {self.arena.tiers[slot] for slot, _ in occupied}
        for t in draft_occ:
            assert t is not None
            by_tier[t] = by_tier.get(t, 0) + k
        for t in verify_occ:
            assert t is not None
            by_tier[t] = by_tier.get(t, 0) + 1
        st.mixed_tier_chunks += len(draft_occ | verify_occ) > 1
        tk = st.tokens_by_tier
        for slot, _ in occupied:
            t = self.arena.tiers[slot]
            assert t is not None
            n = int(dact[:, slot].sum()) + (int(e[slot]) if spec_np[slot]
                                            else 0)
            if n:
                tk[t] = tk.get(t, 0) + n
        if tele is not None:
            # Spec slots are busy all k draft steps and the verify step;
            # plain slots decode through the draft phase only.
            draft_lanes = [
                (draft_tiers[s], k if spec_np[s] else int(dact[:, s].sum()))
                for s in range(self.max_batch)]
            verify_lanes = [(self.arena.tiers[s], 1 if spec_np[s] else 0)
                            for s in range(self.max_batch)]
            tele.on_spec_round(
                t0=t1, ticks0=ticks0, ticks_end=self.clock, k=k,
                draft_lanes=draft_lanes, verify_lanes=verify_lanes,
                fence=self.device, args={"n_spec": n_spec})
        etier = {slot: self.arena.tiers[slot] for slot, _ in occupied}
        for s_i in range(k):
            for slot, state in occupied:
                if dact[s_i, slot]:
                    events.append(self._emit_token(
                        state, int(dtoks[s_i, slot]), etier[slot]))
        for slot, state in spec_states:
            for j in range(int(e[slot])):
                events.append(self._emit_token(
                    state, int(win[slot, j]), etier[slot], speculative=True))
        self._release_done()
        self._raise_deferred()
        return events

    def drain(self) -> Dict[int, List[int]]:
        """Step until idle; returns {uid: tokens} for every finished request."""
        while self.has_work:
            self.step()
        return dict(self.scheduler.finished)

    def run(self, requests: Sequence[Request]) -> Dict[int, List[int]]:
        """Blocking wrapper: submit every request, drain, collect.  A
        request shed at submit maps to its (empty) stream."""
        for r in requests:
            self.submit(r)
        finished = self.drain()
        return {r.uid: finished.get(r.uid, list(self.handles[r.uid].tokens))
                for r in requests}

    @property
    def results(self) -> Dict[int, List[int]]:
        return dict(self.scheduler.finished)


@dataclasses.dataclass
class _BatchState:
    """Host state of the batch the batch-at-a-time engine decodes."""

    batch: List[Request]
    caches: Any
    tok: npt.NDArray[np.int32]     # [B], the tokens the next step emits
    outs: List[List[int]]
    step_idx: int
    max_new: int


class BatchServeEngine(_DeferredErrors):
    """The batch-at-a-time baseline: admit up to ``max_batch`` requests,
    prefill them together (right-padded, per-row true lengths), decode
    EVERY row up to the batch's largest ``max_new_tokens``, then form the
    next batch.  Same ``submit`` / ``step`` / ``drain`` surface as
    :class:`ServeEngine` (one ``step`` = one batch-wide decode step), so
    the :class:`Engine` protocol covers both.  Outputs are exact per
    request; finished rows keep costing decode steps until the batch's
    last — the waste continuous batching removes.

    On a tiered runtime every request runs at ONE tier (``tier``, the
    schedule's default otherwise; ``set_tier`` always raises), and the KV
    cache follows that tier's ``kv_tiers`` precision unless ``kv_bits`` is
    given: the fixed-precision reference for the mixed per-slot arena.
    Greedy only; runs on ``device`` (default cuda).  ``telemetry`` takes
    the lifecycle hooks and one span per prefill and decode step."""

    def __init__(self, model: LM, params: Any, rt: Runtime, *,
                 max_batch: int = 8, max_len: int = 512,
                 kv_bits: Optional[int] = None, packed: bool = False,
                 tier: Optional[str] = None,
                 telemetry: Optional[Any] = None,
                 device: Any = None) -> None:
        if rt.schedule is not None and tier is not None \
                and tier not in rt.schedule.tiers:
            raise ValueError(f"unknown tier {tier!r}; engine serves "
                             f"{sorted(rt.schedule.tiers)}")
        self.device = resolve_device(device)
        self.model = model
        self.tier_name: Optional[str] = None
        if rt.schedule is not None:
            if kv_bits is None:
                kv_bits = rt.schedule.kv_bits_for(tier)
            self.tier_name = tier if tier is not None \
                else rt.schedule.default_tier
            rt = rt.for_tier(tier)
        self.rt = rt
        self.params = _ensure_prepared(params, rt, model, packed)
        self.quantized_paths = quantized_paths(self.params)
        self.max_batch = max_batch
        self.max_len = max_len
        self.kv_bits = kv_bits
        self.stats = EngineStats()
        self.telemetry = telemetry
        if telemetry is not None:
            telemetry.attach_engine(num_slots=max_batch,
                                    schedule=rt.schedule)
        self.handles: Dict[int, RequestHandle] = {}
        self.results: Dict[int, List[int]] = {}
        self._queue: List[Request] = []
        self._seen_uids: Set[int] = set()
        self._active: Optional[_BatchState] = None

    @property
    def clock(self) -> float:
        """Scheduler clock: decode steps executed (ServeEngine's units)."""
        return float(self.stats.decode_steps)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or self._active is not None

    def submit(self, request: Request) -> RequestHandle:
        """Queue one request (ServeEngine's checks); batches form in
        submission order, ``max_batch`` at a time, when ``step`` finds no
        active batch."""
        _validate_request(request, self.max_len, self._seen_uids)
        if request.spec is not None:
            raise ValueError(
                f"request {request.uid}: speculative decoding needs "
                "ServeEngine (the batch baseline has no draft/verify step)")
        if request.sampling is not None:
            request.sampling.validate()
            if request.sampling.temperature > 0.0:
                raise ValueError(
                    f"request {request.uid}: temperature sampling needs "
                    "ServeEngine (the batch baseline decodes greedily); "
                    "temperature=0.0 SamplingParams are accepted as greedy")
        self._seen_uids.add(request.uid)
        handle = RequestHandle(request, self, submitted_at=self.clock)
        self.handles[request.uid] = handle
        self._queue.append(request)
        if self.telemetry is not None:
            self.telemetry.on_submit(handle, ticks=self.clock)
            self.telemetry.sync_stats(self.stats,
                                      queue_depth=len(self._queue))
        return handle

    def _set_tier(self, handle: RequestHandle, tier: str) -> None:
        raise RuntimeError(
            "BatchServeEngine pins one tier for every request; per-request "
            "tier migration needs ServeEngine (mixed_tiers=True)")

    def cancel(self, uid: int) -> None:
        """Drop a QUEUED (not yet batched) request; its handle turns SHED."""
        handle = _cancellable(self, uid, "BatchServeEngine cancels only "
                              "QUEUED requests (it does not preempt)")
        self._queue = [r for r in self._queue if r.uid != uid]
        handle._mark_shed(self.clock)
        self.stats.sheds += 1
        if self.telemetry is not None:
            self.telemetry.on_shed(handle, ticks=self.clock)
            self.telemetry.sync_stats(self.stats,
                                      queue_depth=len(self._queue))

    def retire(self, uid: int) -> List[int]:
        """As :meth:`ServeEngine.retire`."""
        return _retire(self, self.results, uid)

    @torch.inference_mode()
    def _start_batch(self) -> None:
        """Form and prefill the next batch (up to ``max_batch`` requests in
        submission order, right-padded to the longest prompt)."""
        batch = self._queue[:self.max_batch]
        self._queue = self._queue[self.max_batch:]
        b = len(batch)
        plen = max(len(r.prompt) for r in batch)
        prompts = np.zeros((b, plen), np.int32)
        lengths = np.zeros((b,), np.int32)
        for i, r in enumerate(batch):
            prompts[i, :len(r.prompt)] = r.prompt
            lengths[i] = len(r.prompt)
        tele = self.telemetry
        t1 = tele.dispatch_start(self.device) if tele is not None else 0.0
        t0 = time.perf_counter()
        caches = self.model.init_cache(b, self.max_len, kv_bits=self.kv_bits,
                                       device=self.device)
        logits, caches = self.model.prefill(
            self.params, self.rt, caches,
            tokens=torch.from_numpy(prompts).to(self.device),
            seq_lengths=torch.from_numpy(lengths).to(self.device))
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        tok_h = tok.cpu().numpy()
        self.stats.prefill_seconds += time.perf_counter() - t0
        self.stats.prefills += b
        self.stats.prefill_tokens += int(lengths.sum())
        if tele is not None:
            # One batch-wide prefill (uid -1: the whole batch).
            tele.on_prefill(uid=-1, tier=self.tier_name,
                            prompt_len=int(lengths.sum()), t0=t1,
                            ticks=self.clock, fence=self.device)
        for i, r in enumerate(batch):
            self.handles[r.uid]._mark_admitted(i, self.clock)
            if tele is not None:
                tele.on_admit(self.handles[r.uid], slot=i, ticks=self.clock)
        self._active = _BatchState(
            batch=batch, caches=caches, tok=tok_h,
            outs=[[] for _ in range(b)], step_idx=0,
            max_new=max(r.max_new_tokens for r in batch))

    @torch.inference_mode()
    def step(self) -> List[TokenEvent]:
        """One batch-wide decode step (forming a new batch when idle): emit
        the current token of every request still owed one, then advance the
        whole batch.  Returns the emitted tokens; ``[]`` when idle."""
        if self._active is None:
            if not self._queue:
                return []
            self._start_batch()
        a = self._active
        assert a is not None
        events: List[TokenEvent] = []
        for i, r in enumerate(a.batch):
            if a.step_idx < r.max_new_tokens:
                token = int(a.tok[i])
                a.outs[i].append(token)
                event = TokenEvent(uid=r.uid, token=token, index=a.step_idx,
                                   tier=self.tier_name,
                                   final=a.step_idx == r.max_new_tokens - 1)
                events.append(event)
                self.handles[r.uid]._push(event, self.clock,
                                          defer=self._defer_error)
                if self.telemetry is not None:
                    self.telemetry.on_token(event, ticks=self.clock)
        tele = self.telemetry
        t1 = tele.dispatch_start(self.device) if tele is not None else 0.0
        ticks0 = self.clock
        t0 = time.perf_counter()
        logits, a.caches = self.model.decode_step(
            self.params, self.rt, a.caches,
            tokens=torch.from_numpy(a.tok[:, None]).to(self.device))
        a.tok = torch.argmax(logits[:, -1], dim=-1).to(
            torch.int32).cpu().numpy()
        self.stats.decode_seconds += time.perf_counter() - t0
        self.stats.decode_steps += 1
        self.stats.decode_chunks += 1
        self.stats.decode_slot_steps += len(a.batch)
        a.step_idx += 1
        if tele is not None:
            # Every lane of the batch runs the step.
            tele.on_decode_chunk(
                t0=t1, ticks0=ticks0, ticks_end=self.clock, n_steps=1,
                lanes=[(self.tier_name, 1) for _ in a.batch],
                fence=self.device)
            tele.sync_stats(self.stats, queue_depth=len(self._queue))
        if a.step_idx >= a.max_new:
            for i, r in enumerate(a.batch):
                self.results[r.uid] = a.outs[i][:r.max_new_tokens]
            self._active = None
        self._raise_deferred()
        return events

    def drain(self) -> Dict[int, List[int]]:
        """Step until idle; returns {uid: tokens} for finished requests."""
        while self.has_work:
            self.step()
        return dict(self.results)

    def run(self, requests: Sequence[Request]) -> Dict[int, List[int]]:
        """Serve the list batch by batch; returns {uid: tokens}.  A bad
        request anywhere in the list raises before any is queued."""
        seen = set(self._seen_uids)
        for r in requests:
            _validate_request(r, self.max_len, seen)
            seen.add(r.uid)
        for r in requests:
            self.submit(r)
        finished = self.drain()
        return {r.uid: finished[r.uid] for r in requests}
