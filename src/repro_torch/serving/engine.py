"""Multi-tenant serving engine: one frozen base, many FedARA adapters
(reference: ``repro/serving/engine.py``).

Batching model
--------------
The engine owns one cache of ``n_slots`` rows, each with its own position.
Each step it

  1. admits waiting requests into free slots and prefills each one's largest
     power-of-two prompt chunk into its slot (the rest of the prompt is fed
     by decode catch-up, exactly as the JAX engine does, so the token
     streams match);
  2. groups live requests by their adapter's rank bucket and runs one
     batched decode per group (``Model.decode_rows``): the group's distinct
     adapters are stacked at the bucket rank, every row gathers its own
     through ``idx`` (the ``bea_batched`` kernel on the card) and advances
     its own cache position — semantically identical to serving each
     request alone;
  3. feeds each row its next unconsumed prompt token or its last sampled
     token, records greedy samples once the prompt is resident, and retires
     finished requests, freeing their slots for the next admission.

The JAX engine pads decode groups to power-of-two rows to bound jit
retraces; PyTorch runs eagerly, so the port does not pad.

Observability (``repro_torch.obs``), as in the reference: an
``engine.step`` span per step, ``serve.prefill`` / ``serve.decode``
profiler ranges, token counters, the live plane's progress, and two
always-on latency sketches (host wall clock of a step and of a request,
submit to finish) whose p50/p95/p99 ``stats()["latency"]`` reports whether
or not tracing is on.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque

import torch

from repro_torch import obs as OBS
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import Histogram
from repro_torch.pytree import tree_bytes, tree_map
from repro_torch.serving.registry import AdapterRegistry, RegistryFullError
from repro_torch.serving.scheduler import Request, Scheduler


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def stack_adapters(trees: list, masks: list, dtype: torch.dtype):
    """Stack per-tenant adapter and mask trees along a new leading G axis.
    A and B are cast to the compute dtype once here (the kernels read them
    in x's dtype); E stays float32 and masks stay bool."""
    def stack(path_key, *ts):
        t = torch.stack(ts)
        return t.to(dtype) if path_key in ("A", "B") else t

    def walk(nodes):
        first = nodes[0]
        if isinstance(first, dict):
            if "A" in first and "B" in first:
                return {k: stack(k, *(n[k] for n in nodes)) for k in first}
            return {k: walk([n[k] for n in nodes]) for k in first}
        if isinstance(first, list):
            return [walk([n[i] for n in nodes]) for i in range(len(first))]
        raise TypeError(f"unexpected adapter node {type(first)!r}")

    return walk(trees), tree_map(lambda *ts: torch.stack(ts), *masks)


class ServingEngine:
    """Continuous-batching multi-tenant serving over one frozen base model.

    Runs on CUDA unless ``device="cpu"`` is passed; ``base`` is moved to the
    engine's device if it is not there already.
    """

    def __init__(self, model, base, *, registry: AdapterRegistry | None = None,
                 n_slots: int = 8, max_seq: int = 128,
                 bucket_sizes: tuple[int, ...] = (4, 8, 16, 32, 64),
                 chunk_prefill: bool = True, device=None):
        cfg = model.cfg
        if cfg.is_encoder_decoder or cfg.modality != "text":
            raise NotImplementedError(
                f"{cfg.name}: the engine serves decoder-only text models "
                f"(as the reference's engine v1 does); encoder-decoder and "
                f"vision models serve through the static-batch loop, "
                f"repro_torch.launch.serve.legacy_static_batch")
        self.device = resolve_device(device)
        self.model = model
        self.base = tree_map(lambda t: t.to(self.device), base)
        self.cfg = cfg
        self.chunk_prefill = chunk_prefill
        self.scaling = cfg.adapter_alpha / max(cfg.adapter_rank, 1)
        if registry is not None and \
                registry.serving_scaling != self.scaling:
            raise ValueError(
                f"registry.serving_scaling={registry.serving_scaling} does "
                f"not match the model's α/r={self.scaling}; adapters would "
                f"apply at the wrong strength")
        self.registry = registry or AdapterRegistry(
            self.scaling, bucket_sizes=bucket_sizes)
        self.scheduler = Scheduler(n_slots, max_seq)
        self.max_seq = max_seq
        self.n_slots = n_slots

        self.cache_slot_bytes = tree_bytes(model.cache_meta(1, max_seq))
        self.cache = model.init_cache(n_slots, max_seq, self.device)
        self._stack_cache: dict[tuple, tuple] = {}
        self.finished: deque[Request] = deque(maxlen=256)
        self.steps = 0
        self._deferred = 0
        self.decode_calls = 0
        self.prefill_calls = 0
        # host wall time inside prefill / decode calls (each decode ends in
        # a device→host copy of the sampled tokens, so it includes the card)
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self._lat_step = Histogram("serve.step_s", ())
        self._lat_request = Histogram("serve.request_s", ())
        self._t_submit: dict[int, float] = {}

    # ---- tenant management -------------------------------------------------

    def register_adapter(self, adapter_id: str, trainable, masks, *,
                         rank: int | None = None, alpha: float | None = None,
                         scaling: float | None = None, pin: bool = False):
        """Admit one tenant's trained adapters (see AdapterRegistry)."""
        trainable = tree_map(lambda t: t.to(self.device), trainable)
        masks = tree_map(lambda t: t.to(self.device), masks)
        return self.registry.register(adapter_id, trainable, masks, rank=rank,
                                      alpha=alpha, scaling=scaling, pin=pin)

    # ---- request intake ----------------------------------------------------

    def submit(self, adapter_id: str, prompt, max_new_tokens: int,
               eos_id: int | None = None) -> Request:
        req = self.scheduler.submit(adapter_id, prompt, max_new_tokens,
                                    eos_id=eos_id)
        self._t_submit[req.rid] = time.perf_counter()
        return req

    # ---- the serving loop --------------------------------------------------

    def step(self) -> list[Request]:
        """One engine iteration; returns the requests finished this step."""
        t_step = time.perf_counter()
        self.steps += 1
        self.scheduler.step_count = self.steps
        self._deferred = 0
        self._prune_stacks()
        ssp = OBS.get_tracer().begin("engine.step", kind="serving",
                                     step=self.steps)

        to_defer = []
        for req in self.scheduler.admit():
            try:
                req.entry = self.registry.acquire(req.adapter_id)
            except KeyError:
                self.scheduler.reject(
                    req, f"unknown adapter {req.adapter_id!r}",
                    kind="unknown_adapter")
                self._t_submit.pop(req.rid, None)
                continue
            except RegistryFullError:
                to_defer.append(req)                  # retry next step
                continue
            self._prefill(req)
        # defer() prepends — reversed keeps FIFO order across multiple defers
        for req in reversed(to_defer):
            self._deferred += 1
            self.scheduler.defer(req)

        groups: dict[int, list[Request]] = defaultdict(list)
        for req in self.scheduler.running():
            if not req.done:
                groups[req.entry.bucket].append(req)
        for bucket in sorted(groups):
            self._decode_group(groups[bucket])

        done = []
        now = time.perf_counter()
        for req in self.scheduler.running():
            if req.done:
                self.scheduler.finish(req)
                self.registry.release(req.adapter_id)
                req.entry = None
                done.append(req)
                lat = now - self._t_submit.pop(req.rid, now)
                self._lat_request.observe(lat)
                OBS.get_metrics().histogram("serve.request_s").observe(lat)
        self.finished.extend(done)
        step_s = time.perf_counter() - t_step
        self._lat_step.observe(step_s)
        OBS.get_metrics().histogram("serve.step_s").observe(step_s)
        ssp.end(running=self.scheduler.n_running,
                waiting=self.scheduler.n_waiting, finished=len(done),
                deferred=self._deferred)
        tr = OBS.get_tracer()
        if tr.live is not None:
            # live plane refresh at the step boundary, throttled
            tr.live.publish(tr, progress={
                "steps": self.steps, "running": self.scheduler.n_running,
                "waiting": self.scheduler.n_waiting,
                "finished": self.scheduler.n_finished},
                min_interval=0.25)
        return done

    def run(self, max_steps: int | None = None) -> list[Request]:
        """Drive until every submitted request completes."""
        out = []
        while not self.scheduler.idle:
            done = self.step()
            out.extend(done)
            # no finishes, nothing running, every admission deferred: the
            # next step would be identical — the registry is wedged
            if not done and self.scheduler.n_running == 0 and self._deferred:
                raise RegistryFullError(
                    "no request can acquire its adapter (registry wedged by "
                    "pinned entries) and nothing is running — aborting")
            if max_steps is not None and self.steps >= max_steps:
                break
        return out

    # ---- internals ---------------------------------------------------------

    def _prefill(self, req: Request) -> None:
        t0 = time.perf_counter()
        entry = req.entry
        n = req.prompt_len
        chunk = min(_pow2_floor(n), n) if self.chunk_prefill else n
        toks = torch.as_tensor(req.prompt[:chunk], dtype=torch.long,
                               device=self.device)[None]              # (1, C)
        stacks, smasks = self._stacked([entry])
        ads = tree_map(lambda t: t[0], stacks)
        msk = tree_map(lambda t: t[0], smasks)
        slot_cache = self.model.init_cache(1, self.max_seq, self.device)
        with OBS.annotate("serve.prefill"):
            logits, new_cache = self.model.prefill(
                self.base, {"adapters": ads}, msk, toks, slot_cache)
        for dst, src in zip(self.cache["dec"]["layers"],
                            new_cache["dec"]["layers"]):
            dst["k"][req.slot] = src["k"][0]
            dst["v"][req.slot] = src["v"][0]
        self.cache["pos"][req.slot] = chunk
        self.prefill_calls += 1
        OBS.get_metrics().counter("serve.prefill_tokens").inc(chunk)
        req.n_cached = chunk
        if chunk >= n:                  # whole prompt resident → first sample
            req.out.append(int(torch.argmax(logits[0])))
        self.prefill_s += time.perf_counter() - t0

    def _stacked(self, entries: list):
        """Rank-bucket stacks of the given adapter entries, cached by their
        serials."""
        key = tuple(e.serial for e in entries)
        hit = self._stack_cache.get(key)
        if hit is not None:
            return hit
        out = stack_adapters([e.adapters for e in entries],
                             [e.masks for e in entries], self.cfg.cdtype)
        if len(self._stack_cache) > 256:
            self._stack_cache.clear()
        self._stack_cache[key] = out
        return out

    def _prune_stacks(self) -> None:
        """Drop stacks referencing evicted/re-registered adapters so cached
        copies don't outlive the registry's memory accounting."""
        if not self._stack_cache:
            return
        live = self.registry.live_serials()
        self._stack_cache = {k: v for k, v in self._stack_cache.items()
                             if set(k) <= live}

    def _decode_group(self, reqs: list[Request]) -> None:
        t0 = time.perf_counter()
        reqs = sorted(reqs, key=lambda r: (r.entry.serial, r.slot))
        entries, idx = [], []
        for r in reqs:
            if not entries or entries[-1].serial != r.entry.serial:
                entries.append(r.entry)
            idx.append(len(entries) - 1)
        stacks, smasks = self._stacked(entries)
        dev = self.device
        rows = torch.as_tensor([r.slot for r in reqs], dtype=torch.long,
                               device=dev)
        toks = torch.as_tensor([r.next_input() for r in reqs],
                               dtype=torch.long, device=dev)
        with OBS.annotate("serve.decode"):
            logits = self.model.decode_rows(
                self.base, stacks, smasks,
                torch.as_tensor(idx, dtype=torch.int32, device=dev), toks,
                self.cache, rows)
        self.decode_calls += 1
        OBS.get_metrics().counter("serve.decode_tokens").inc(len(reqs))
        sampled = torch.argmax(logits, dim=-1).tolist()
        for r, tok in zip(reqs, sampled):
            r.observe(int(tok))
        self.decode_s += time.perf_counter() - t0

    # ---- introspection -----------------------------------------------------

    def stats(self) -> dict:
        return {"steps": self.steps, "prefill_calls": self.prefill_calls,
                "decode_calls": self.decode_calls,
                "prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "finished": self.scheduler.n_finished,
                "running": self.scheduler.n_running,
                "waiting": self.scheduler.n_waiting,
                "scheduler": self.scheduler.stats(),
                "registry": self.registry.stats(),
                "latency": {"step_s": self._lat_step.summary(),
                            "request_s": self._lat_request.summary()},
                "cache": self.scheduler.slot_bytes(self.cache_slot_bytes)}
