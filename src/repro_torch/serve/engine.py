"""Slot-based continuous-batching serving engine (port of
``repro.serve.engine``: ``prepare_params``, ``PREPARE_CALLS`` and
``ServeEngine`` with per-slot bucketed prefill, the decode-chunk loop, the
group-layout memo and greedy selection).

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
* **Decode chunks** — ``decode_chunk`` greedy steps run back to back on
  the device with an active-slot mask; the host reads the chunk's tokens
  with ONE copy at its end and only then admits/retires requests.

Greedy selection is the argmax of the raw logits, which is what the
reference's sampler does at temperature 0.  Requests that ask for
sampling or speculation, and engines asked for preemption, a mesh, per-tier
KV precision (``kv_tiers``) or ``set_tier`` migration, raise ``NotImplementedError`` naming the ROADMAP item that ports them.

The scheduler clock is the number of decode steps executed
(``ServeEngine.clock``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import numpy.typing as npt
import torch

from repro_torch.core.policy import INTEGER_BACKENDS, PrecisionPolicy
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import Runtime
from repro_torch.models.transformer import LM
from repro_torch.serve import slots as slots_lib
from repro_torch.serve.handle import RequestHandle, TokenEvent
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import Scheduler

__all__ = ["Request", "ServeEngine", "EngineStats", "prepare_params",
           "prepare_tree", "PREPARE_CALLS"]

# Mixed-tier group layout: the tuple of (tier name, rows) runs describing a
# tier-sorted decode batch (see Runtime.for_groups).
GroupLayout = Tuple[Tuple[str, int], ...]

# Global weight-preparation counter: every prepare_params call (one
# quantize + decompose sweep over the params) bumps it.
PREPARE_CALLS = 0

TODO_SAMPLING = ("sampling and speculative decoding are ROADMAP Queue 1 "
                 "item 6, not ported yet; the port serves greedy decoding")
TODO_PREEMPT = "preemption is ROADMAP Queue 1 item 7, not ported yet"
TODO_MESH = "tensor-parallel serving is ROADMAP Queue 1 item 11, not ported yet"
TODO_KV_TIERS = ("per-tier KV precision (kv_tiers) and set_tier KV migration "
                 "are ROADMAP Queue 1 items 3-4, not ported yet")


def _layer_name(path: Tuple[Any, ...]) -> str:
    """("layers", 3, "pos0", "attn", "q_proj", "w") -> layers.pos0.attn.q_proj"""
    parts = [str(p) for p in path if not isinstance(p, int)]
    if parts and parts[-1] == "w":
        parts = parts[:-1]
    return ".".join(parts)


def prepare_tree(tree: Any, policy: PrecisionPolicy, *,
                 superplane: bool = False, packed: bool = False,
                 prefix: Tuple[Any, ...] = (),
                 paths: Optional[List[str]] = None) -> Any:
    """A copy of ``tree`` (dicts and lists of tensors) with every projection
    weight — a 2D ``w`` outside the embedding — replaced by its
    QuantizedWeight (the superplane store if ``superplane``; byte-packed
    if ``packed``).  ``prefix``
    is the key path of ``tree`` inside the full params, which names each
    weight for the policy lookup.  Does not count as a ``prepare_params``
    call: it is the per-subtree worker (``LM.init``'s prepare hook)."""
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            path = prefix + (key,)
            is_proj = (key == "w" and isinstance(val, torch.Tensor)
                       and val.ndim >= 2 and "embed" not in path)
            if is_proj:
                if val.ndim != 2:
                    raise NotImplementedError(
                        "stacked (expert) weights arrive with MoE, ROADMAP "
                        "Queue 1 item 9")
                prec = policy.lookup(_layer_name(path))
                w = val.to(torch.float32)
                out[key] = (ops.prepare_superplane(w, signed=prec.w_signed,
                                                   packed=packed)
                            if superplane
                            else ops.prepare_weight(w, prec, packed=packed))
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
    which waits for the device."""

    prefills: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0
    decode_chunks: int = 0
    decode_slot_steps: int = 0
    decode_idle_slot_steps: int = 0
    mixed_tier_chunks: int = 0
    layout_cache_hits: int = 0
    layout_cache_misses: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    decode_steps_by_tier: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    tokens_by_tier: Dict[str, int] = dataclasses.field(default_factory=dict)


class ServeEngine:
    """Continuous batching over ``max_batch`` persistent slots.

    Requests enter through ``submit`` any time (``run`` for the blocking
    form); freed slots are re-prefilled one by one against the shared
    cache arena while the other slots' caches stay untouched, and decoding
    runs ``decode_chunk`` steps per round.  With a ``PrecisionSchedule`` on
    the runtime, slots are tier-tagged and each chunk serves the occupied
    tiers together (``fused_decode``: one group-switching GEMM per
    projection, else the per-group reference loop).  ``packed`` prepares
    unprepared params as the byte-packed store.  Everything runs on
    ``device`` (default cuda); the params must live there."""

    def __init__(self, model: LM, params: Any, rt: Runtime, *,
                 max_batch: int = 8, max_len: int = 512,
                 kv_bits: Optional[int] = None, decode_chunk: int = 8,
                 prompt_bucket: int = 8, packed: bool = False,
                 fused_decode: bool = True, mesh: Optional[Any] = None,
                 device: Any = None) -> None:
        if mesh is not None:
            raise NotImplementedError(TODO_MESH)
        if rt.schedule is not None and rt.schedule.kv_tiers is not None:
            raise NotImplementedError(TODO_KV_TIERS)
        self.device = resolve_device(device)
        self.model = model
        self.rt = dataclasses.replace(rt, fused=fused_decode)
        self.max_batch = max_batch
        self.max_len = max_len
        self.kv_bits = kv_bits
        self.decode_chunk = max(1, decode_chunk)
        self.prompt_bucket = max(1, prompt_bucket)
        self.params = _ensure_prepared(params, rt, model, packed)
        self.schedule = rt.schedule
        self.arena = slots_lib.SlotArena(model, max_batch, max_len,
                                         kv_bits=kv_bits, device=self.device)
        self.scheduler = Scheduler(max_batch)
        self.stats = EngineStats()
        self._layout_cache: Dict[Tuple[Optional[str], ...],
                                 Tuple[GroupLayout, npt.NDArray[np.int64]]] = {}
        self.handles: Dict[int, RequestHandle] = {}
        self._seen_uids: Set[int] = set()
        # Host-mirrored per-slot decode state.
        self._tok: npt.NDArray[np.int32] = np.zeros((max_batch,), np.int32)
        self._remaining: npt.NDArray[np.int32] = np.zeros((max_batch,),
                                                          np.int32)

    # ------------------------------------------------------------------ clock
    @property
    def clock(self) -> float:
        """Deterministic scheduler clock: decode steps executed so far."""
        return float(self.stats.decode_steps)

    @property
    def has_work(self) -> bool:
        """True while anything waits or decodes."""
        return self.scheduler.has_work

    # ----------------------------------------------------------------- intake
    def submit(self, request: Request) -> RequestHandle:
        """Queue one request; returns its streaming :class:`RequestHandle`.
        On a tiered engine the queued copy carries a concrete tier name."""
        _validate_request(request, self.max_len, self._seen_uids)
        if request.sampling is not None or request.spec is not None:
            raise NotImplementedError(TODO_SAMPLING)
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
        self._seen_uids.add(request.uid)
        handle = RequestHandle(request, self, submitted_at=self.clock)
        self.handles[request.uid] = handle
        self.scheduler.submit(request, now=self.clock)
        return handle

    def _set_tier(self, handle: RequestHandle, tier: str) -> None:
        raise NotImplementedError(TODO_KV_TIERS)

    def preempt(self, uid: int) -> None:
        raise NotImplementedError(TODO_PREEMPT)

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

    def _emit_token(self, state: Any, token: int,
                    tier: Optional[str]) -> TokenEvent:
        """Record one emitted token on slot state + handle."""
        index = len(state.tokens)
        state.emit(token)
        event = TokenEvent(uid=state.uid, token=token, index=index,
                           tier=tier, final=state.done)
        self.handles[state.uid]._push(event, self.clock)
        return event

    @torch.inference_mode()
    def _prefill_slot(self, slot: int, padded: npt.NDArray[np.int32],
                      plen: int, tier: Optional[str]) -> int:
        """Reset one slot, prefill its right-padded prompt through a view of
        the arena (written in place), return the first token (greedy)."""
        caches = slots_lib.slot_reset(self.arena.caches, slot)
        sub = slots_lib.slot_view(caches, slot)
        tokens = torch.from_numpy(padded).to(self.device)
        lengths = torch.tensor([plen], dtype=torch.int32, device=self.device)
        logits, _ = self.model.prefill(self.params, self.rt.for_tier(tier),
                                       sub, tokens=tokens,
                                       seq_lengths=lengths)
        return int(torch.argmax(logits[0, -1]))

    def _admit_free_slots(self) -> List[TokenEvent]:
        """Fill free slots from the waiting queue and prefill each admitted
        request; returns the prefill-emitted first tokens as events."""
        events: List[TokenEvent] = []
        for slot in self.scheduler.free_slots():
            req = self.scheduler.admit(slot, now=self.clock)
            if req is None:
                break
            padded, plen = self._bucket_pad(np.asarray(req.prompt))
            t0 = time.perf_counter()
            first = self._prefill_slot(slot, padded, plen, req.tier)
            self.stats.prefill_seconds += time.perf_counter() - t0
            self.arena.tiers[slot] = req.tier
            self.stats.prefills += 1
            self.stats.prefill_tokens += plen
            state = self.scheduler.slots[slot]
            assert state is not None
            self.handles[req.uid]._mark_admitted(slot, self.clock)
            events.append(self._emit_token(state, first, req.tier))
            self._tok[slot] = first
            self._remaining[slot] = state.remaining
        return events

    def _release_done(self) -> None:
        """Release exhausted slots and clear their arena tier tags."""
        for slot in self.scheduler.release_done():
            self.arena.tiers[slot] = None

    def _group_layout(self) -> Tuple[GroupLayout, npt.NDArray[np.int64]]:
        """The per-step mixed-tier layout from the slot tier tags:
        ``(groups, perm)`` with groups in schedule tier order (free slots
        ride in the default tier's group; their lanes are masked) and
        ``perm`` the slot order realizing it.  Memoized on the slot-tier
        vector (``layout_cache_hits`` / ``layout_cache_misses``)."""
        schedule = self.schedule
        assert schedule is not None
        cache_key = tuple(self.arena.tiers)
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

    @torch.inference_mode()
    def _decode_chunk(self, rt: Runtime, n_steps: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """``n_steps`` greedy decode steps with an active-slot mask: a slot
        whose budget hits zero stops writing its cache THAT step.  Returns
        host copies (one transfer) of tok [B], remaining [B] and the
        per-step tokens / actives [n_steps, B]."""
        dev = self.device
        tok = torch.from_numpy(self._tok).to(dev)
        remaining = torch.from_numpy(self._remaining).to(dev)
        rows = []
        for _ in range(n_steps):
            active = remaining > 0
            logits, _ = self.model.decode_step(
                self.params, rt, self.arena.caches, tokens=tok[:, None],
                active=active)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            tok = torch.where(active, nxt, tok)
            remaining = remaining - active.to(torch.int32)
            rows += [tok, active.to(torch.int32)]
        host = torch.stack(rows + [tok, remaining]).cpu().numpy()
        toks = host[0:2 * n_steps:2]
        actives = host[1:2 * n_steps:2].astype(bool)
        return host[-2].copy(), host[-1].copy(), toks, actives

    def step(self) -> List[TokenEvent]:
        """One scheduling round: admit into free slots, run one decode chunk
        over the occupied slots, and account its tokens.  Returns every
        token emitted this round in emission order."""
        events = self._admit_free_slots()
        self._release_done()                       # max_new_tokens == 1 cases
        occupied = self.scheduler.occupied()
        if not occupied:
            return events
        # Trim the chunk so a tail of all-finished steps is never run.
        n_steps = int(min(self.decode_chunk,
                          max(s.remaining for _, s in occupied)))
        if self.schedule is not None:
            groups, perm = self._group_layout()
            rt = self.rt.for_groups(groups,
                                    torch.from_numpy(perm).to(self.device))
        else:
            rt = self.rt
        t0 = time.perf_counter()
        self._tok, self._remaining, toks, actives = self._decode_chunk(
            rt, n_steps)
        self.stats.decode_seconds += time.perf_counter() - t0
        self.stats.decode_chunks += 1
        self.stats.decode_steps += n_steps
        self.stats.decode_slot_steps += int(actives.sum())
        self.stats.decode_idle_slot_steps += int((~actives).sum())
        if self.schedule is not None:
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
        etier = {s_: self.arena.tiers[s_] for s_, _ in occupied}
        for s in range(n_steps):
            for slot, state in occupied:
                if actives[s, slot]:
                    events.append(self._emit_token(state, int(toks[s, slot]),
                                                   etier[slot]))
        self._release_done()
        return events

    def drain(self) -> Dict[int, List[int]]:
        """Step until idle; returns {uid: tokens} for every finished request."""
        while self.has_work:
            self.step()
        return dict(self.scheduler.finished)

    def run(self, requests: Sequence[Request]) -> Dict[int, List[int]]:
        """Blocking wrapper: submit every request, drain, collect."""
        for r in requests:
            self.submit(r)
        finished = self.drain()
        return {r.uid: finished[r.uid] for r in requests}

    @property
    def results(self) -> Dict[int, List[int]]:
        return dict(self.scheduler.finished)
