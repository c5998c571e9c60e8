"""Every FedPEFT baseline the paper compares against (reference:
``repro/federated/baselines.py``; paper §V Baselines).

FedLoRA        plain LoRA + FedAvg
FedAdapter-h   Houlsby bottleneck adapters (attention + FFN)
FedAdapter-p   Pfeiffer bottleneck adapters (FFN only)
SLoRA          stage 1 sparse full-FT → SVD init of LoRA → stage 2 FedLoRA
FeDeRA         LoRA initialized from the SVD of the pre-trained weights
FFA-LoRA       B-only training (A frozen); -dr: doubled rank, orthogonal A
FedSVD         paper's ablation: BEA without dynamic rank allocation
FedARA         the paper (core/fedara.py)

The QR and SVD initializations run in numpy float32 on the host, as in the
reference, so the same weights give the same factors.  The port's layers are
a list (``dec.layers.<i>``), never scanned stacks, so FeDeRA and SLoRA
rewrite every layer; the reference does that only for unrolled models.
SLoRA's stage-1 gate is drawn from a stable hash of each leaf's path (the
reference folds Python's per-process salted ``hash`` into its key).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import adapters as AD
from repro_torch.core.fedara import FedARA, FedSVD, Strategy
from repro_torch.pytree import (_leaf_seed, flatten_with_keys, leaves,
                                tree_map, unflatten_keys)


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


@dataclasses.dataclass
class FedLoRA(Strategy):
    name: str = "fedlora"
    peft: str = AD.LORA


@dataclasses.dataclass
class FedAdapterH(Strategy):
    name: str = "fedadapter_h"
    peft: str = "adapter_h"


@dataclasses.dataclass
class FedAdapterP(Strategy):
    name: str = "fedadapter_p"
    peft: str = "adapter_p"


def _is_module(tree) -> bool:
    return isinstance(tree, dict) and "A" in tree and "B" in tree


def _iter_adapter_modules(tree, path=""):
    if _is_module(tree):
        yield path, tree
        return
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else ())
    for k, v in items:
        yield from _iter_adapter_modules(v, f"{path}.{k}" if path else str(k))


def _map_modules(tree, fn, path=""):
    if _is_module(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_modules(v, fn, f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_modules(v, fn, f"{path}.{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return tree


@dataclasses.dataclass
class FFALoRA(Strategy):
    """Freeze A, train B only [Sun et al. ICLR'24]; halves the upload."""
    name: str = "ffa_lora"
    peft: str = AD.LORA
    double_rank: bool = False       # the -dr variant
    orthogonal_a: bool = False

    def init_rank(self, cfg) -> int:
        return cfg.adapter_rank * (2 if self.double_rank else 1)

    def post_init(self, model, base, trainable):
        if self.orthogonal_a:
            def ortho(path, mod):
                a = _np32(mod["A"])
                flat = a.reshape(-1, a.shape[-1])
                q, _ = np.linalg.qr(flat.T)            # (d_in, r·lead)
                a2 = q.T.reshape(a.shape) / np.sqrt(a.shape[-1]) * \
                    np.sqrt(flat.shape[1])
                return dict(mod, A=torch.as_tensor(a2).to(
                    mod["A"].device, mod["A"].dtype))
            trainable = dict(trainable, adapters=_map_modules(
                trainable["adapters"], ortho))
        return base, trainable

    def optimizer_gate(self, trainable, masks):
        def gate(path, mod):
            return {k: torch.full((), 0.0 if k == "A" else 1.0,
                                  device=v.device) for k, v in mod.items()}
        out = {"adapters": _map_modules(trainable["adapters"], gate)}
        if "head" in trainable:
            out["head"] = {k: torch.ones((), device=v.device)
                           for k, v in trainable["head"].items()}
        return out

    def comm_down(self, trainable, masks) -> int:
        # A is frozen and derivable from the shared seed: transmit B only.
        b_params = sum(int(np.prod(tuple(m["B"].shape)))
                       for _, m in _iter_adapter_modules(trainable["adapters"]))
        return b_params * self.dtype_bytes + self._head_bytes(trainable)

    def comm_up(self, trainable, masks) -> int:
        return self.comm_down(trainable, masks)


@dataclasses.dataclass
class FeDeRA(Strategy):
    """Init LoRA from the truncated SVD of W_pre; base keeps the residual."""
    name: str = "federa"
    peft: str = AD.LORA

    def post_init(self, model, base, trainable):
        new_base = tree_map(lambda t: t, base)          # new containers

        def reinit(path, mod):
            w = _find_base_weight(new_base, path)
            if w is None or w.ndim != 2:
                return mod
            r = mod["A"].shape[-2]
            wf = _np32(w)                                   # (d_in, d_out)
            u, s, vt = np.linalg.svd(wf, full_matrices=False)
            sr = np.sqrt(s[:r])
            a = (u[:, :r] * sr).T                           # (r, d_in)
            b = (vt[:r].T * sr)                             # (d_out, r)
            scaling = model.cfg.adapter_alpha / max(r, 1)
            _set_base_weight(new_base, path,
                             wf - scaling * (u[:, :r] * s[:r]) @ vt[:r])
            return dict(mod, A=_like(a, mod["A"]), B=_like(b, mod["B"]))

        adapters = _map_modules(trainable["adapters"], reinit)
        return new_base, dict(trainable, adapters=adapters)


@dataclasses.dataclass
class SLoRA(Strategy):
    """Two-stage [Babakniya et al. 2023]: sparse full-FT warmup, then the SVD
    of the accumulated base delta initializes LoRA (stage 1 = 10% of rounds,
    paper §V).  The server runs stage-1 clients as full-FT with a fixed
    sparse update gate; comm counts density·|base| values per direction."""
    name: str = "slora"
    peft: str = AD.LORA
    sparse_density: float = 0.05
    stage1_frac: float = 0.1

    def stage1_rounds(self, total_rounds: int) -> int:
        return max(1, int(total_rounds * self.stage1_frac))

    def sparse_gate(self, base, seed: int = 0):
        """0/1 float32 tree over ``base``, each entry 1 with probability
        ``sparse_density``, drawn on the leaf's device from a generator
        seeded by ``seed`` and a sha256 of the leaf's path (stable across
        processes); non-float leaves get a scalar 0."""
        def leaf(path, x):
            if not x.dtype.is_floating_point:
                return torch.zeros((), device=x.device)
            gen = torch.Generator(device=x.device)
            gen.manual_seed(_leaf_seed(seed, path))
            u = torch.rand(tuple(x.shape), generator=gen, device=x.device)
            return (u < self.sparse_density).float()

        return unflatten_keys([(keys, leaf(".".join(map(str, keys)), x))
                               for keys, x in flatten_with_keys(base)], base)

    def stage1_comm_bytes(self, base) -> int:
        n = sum(int(np.prod(tuple(x.shape))) for x in leaves(base))
        return int(n * self.sparse_density) * self.dtype_bytes

    def svd_init_from_delta(self, model, base0, base1, trainable):
        """ΔW = base1 − base0 → per-module truncated SVD → LoRA init."""
        def reinit(path, mod):
            w0 = _find_base_weight(base0, path)
            w1 = _find_base_weight(base1, path)
            if w0 is None or w0.ndim != 2:
                return mod
            r = mod["A"].shape[-2]
            delta = _np32(w1) - _np32(w0)
            u, s, vt = np.linalg.svd(delta, full_matrices=False)
            sr = np.sqrt(np.maximum(s[:r], 1e-12))
            scaling = model.cfg.adapter_alpha / max(r, 1)
            a = (u[:, :r] * sr).T / np.sqrt(scaling)
            b = (vt[:r].T * sr) / np.sqrt(scaling)
            return dict(mod, A=_like(a, mod["A"]), B=_like(b, mod["B"]))

        return dict(trainable, adapters=_map_modules(
            trainable["adapters"], reinit))


# ---- helpers to navigate base weights for FeDeRA/SLoRA ---------------------

_ATTN_FUSED = {"wq", "wk", "wv", "wo"}


def _like(arr: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(arr).to(t.device, t.dtype)


def _node(tree, part: str):
    if isinstance(tree, dict):
        return tree.get(part)
    if isinstance(tree, list) and part.isdigit() and int(part) < len(tree):
        return tree[int(part)]
    return None


def _find_base_weight(base, adapter_path: str):
    """Map an adapter path (e.g. ``dec.layers.0.attn.wq``) to the base
    weight.  Attention weights are stored 3D and viewed 2D: ``wo``
    (H, hd, d) as (H·hd, d), the others (d, H, hd) as (d, H·hd)."""
    node = base
    parts = adapter_path.split(".")
    for p in parts:
        node = _node(node, p)
        if node is None:
            return None
    if isinstance(node, dict) and "w" in node:
        w = node["w"]
        if w.ndim == 3 and parts[-1] in _ATTN_FUSED:
            if parts[-1] == "wo":
                return w.reshape(-1, w.shape[-1])
            return w.reshape(w.shape[0], -1)
        return w
    return None


def _set_base_weight(base, adapter_path: str, value: np.ndarray):
    node = base
    parts = adapter_path.split(".")
    for p in parts:
        node = _node(node, p)
    w = node["w"]
    node["w"] = _like(value, w).reshape(w.shape)


def all_strategies(rounds: int = 100) -> dict[str, Strategy]:
    return {
        "fedlora": FedLoRA(),
        "fedadapter_h": FedAdapterH(),
        "fedadapter_p": FedAdapterP(),
        "slora": SLoRA(),
        "federa": FeDeRA(),
        "ffa_lora": FFALoRA(),
        "ffa_lora_dr": FFALoRA(name="ffa_lora_dr", double_rank=True,
                               orthogonal_a=True),
        "fedsvd": FedSVD(),
        "fedara": FedARA(total_rounds=rounds),
    }
