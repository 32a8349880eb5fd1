"""The model's sizes as the benchmark reads them from a configuration file,
the parameter layout both sides use, and the weights, drawn from the seed
on the device.

Every slice of a weight (one layer of a stacked leaf, one expert of a
layer) is drawn by its own ``torch.Generator``, seeded from the run's
seed and the slice's name, so the plain reference can draw any slice
again by itself, one layer at a time, after the program has been freed.
The layout (leaf names, shapes, the order of the flat f32 vector) is the
program's interface, written out here from its documented rule: leaves
in sorted key order, depth first, each layer-stacked on its leading dim.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class Spec:
    """The sizes of one configuration file."""
    family: str          # dense | moe
    d: int
    ff: int
    heads: int
    kv: int
    hd: int
    layers: int
    vocab: int
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    theta: float = 10000.0
    eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.dtype]


def spec_of(cfg: dict) -> Spec:
    """A configuration file's sizes (Hugging Face key names)."""
    return Spec(family=cfg["family"], d=cfg["hidden_size"],
                ff=cfg["intermediate_size"],
                heads=cfg["num_attention_heads"],
                kv=cfg["num_key_value_heads"], hd=cfg["head_dim"],
                layers=cfg["num_hidden_layers"], vocab=cfg["vocab_size"],
                experts=cfg.get("num_experts", 0),
                top_k=cfg.get("num_experts_per_tok", 0),
                capacity_factor=cfg.get("capacity_factor", 1.25),
                theta=cfg.get("rope_theta", 10000.0),
                eps=cfg.get("norm_eps", 1e-5),
                dtype=cfg.get("torch_dtype", "bfloat16"))


# (path, shape, init, contraction width); stacked leaves lead with L,
# expert leaves with (L, E)
Leaf = Tuple[str, Tuple[int, ...], str, int]


def leaves(s: Spec) -> List[Leaf]:
    """Every leaf in flat order (sorted keys, depth first)."""
    L, D = s.layers, s.d
    blocks = {
        "attn/wk": ((L, D, s.kv, s.hd), "normal", D),
        "attn/wo": ((L, s.heads, s.hd, D), "normal", s.heads * s.hd),
        "attn/wq": ((L, D, s.heads, s.hd), "normal", D),
        "attn/wv": ((L, D, s.kv, s.hd), "normal", D),
        "ln1/w": ((L, D), "ones", 0),
        "ln2/w": ((L, D), "ones", 0),
    }
    if s.family == "moe":
        E = s.experts
        blocks.update({
            "moe/router": ((L, D, E), "normal", D),
            "moe/wd": ((L, E, s.ff, D), "normal", s.ff),
            "moe/wg": ((L, E, D, s.ff), "normal", D),
            "moe/wu": ((L, E, D, s.ff), "normal", D),
        })
    else:
        blocks.update({
            "mlp/wd": ((L, s.ff, D), "normal", s.ff),
            "mlp/wg": ((L, D, s.ff), "normal", D),
            "mlp/wu": ((L, D, s.ff), "normal", D),
        })
    out = [("blocks/" + k, *blocks[k]) for k in sorted(blocks)]
    out += [("embed", (s.vocab, D), "embed", 0),
            ("final_norm/w", (D,), "ones", 0),
            ("head", (D, s.vocab), "normal", D)]
    return out


def flat_offsets(s: Spec) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
    """path -> (offset, shape) in the flat f32 vector."""
    out, off = {}, 0
    for path, shape, _, _ in leaves(s):
        out[path] = (off, shape)
        off += math.prod(shape)
    return out


def flat_size(s: Spec) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in leaves(s))


def is_expert(path: str) -> bool:
    return path.split("/")[-2:-1] == ["moe"] and not path.endswith("router")


def slices(path: str, shape) -> Iterator[Tuple[int, ...]]:
    """The index prefixes a leaf is drawn in: per layer, per expert."""
    if not path.startswith("blocks/"):
        yield ()
        return
    for l in range(shape[0]):
        if is_expert(path):
            for e in range(shape[1]):
                yield (l, e)
        else:
            yield (l,)


def _slice_seed(seed: int, path: str, idx: Tuple[int, ...]) -> int:
    h = hashlib.sha256(f"{seed}/{path}/{idx}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def draw(s: Spec, path: str, idx: Tuple[int, ...], seed: int,
         device, dtype: torch.dtype = None) -> torch.Tensor:
    """One slice of leaf ``path`` (``idx`` as ``slices`` gives it), in the
    served dtype's values, returned as ``dtype`` (default: served)."""
    leaf = next(l for l in leaves(s) if l[0] == path)
    _, shape, init, fan = leaf
    shape = shape[len(idx):]
    dtype = dtype or s.torch_dtype
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(_slice_seed(seed, path, idx))
    std = 1.0 if init == "embed" else 1.0 / math.sqrt(fan)
    x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    x.mul_(std)
    return x.to(s.torch_dtype).to(dtype)


def fill(s: Spec, path: str, out: torch.Tensor, seed: int) -> None:
    """Write leaf ``path`` into ``out`` (its full shape), slice by slice."""
    for idx in slices(path, out.shape):
        out[idx].copy_(draw(s, path, idx, seed, out.device, out.dtype))


def fill_tree(s: Spec, tree: dict, seed: int) -> None:
    """Write every leaf into a nested dict of tensors keyed by path."""
    for path, _, _, _ in leaves(s):
        node = tree
        for key in path.split("/"):
            node = node[key]
        fill(s, path, node, seed)


def flat_vector(s: Spec, seed: int, device) -> torch.Tensor:
    """The weights as one flat f32 vector in the layout's order."""
    flat = torch.empty(flat_size(s), dtype=torch.float32, device=device)
    for path, (off, shape) in flat_offsets(s).items():
        fill(s, path, flat[off: off + math.prod(shape)].view(shape), seed)
    return flat


def leaf_views(s: Spec, flat: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
    """(name, view) of each leaf of a flat vector, stacked leaves split by
    layer (``path@l``)."""
    out = []
    for path, (off, shape) in flat_offsets(s).items():
        v = flat[off: off + math.prod(shape)].view(shape)
        if path.startswith("blocks/"):
            out += [(f"{path}@{l}", v[l]) for l in range(shape[0])]
        else:
            out.append((path, v))
    return out


def _leaf_slices(s: Spec, name: str, v: torch.Tensor):
    """(draw index, view) of each drawn slice of a per-layer leaf."""
    path, _, layer = name.partition("@")
    if not layer:
        return [((), v)]
    l = int(layer)
    if is_expert(path):
        return [((l, e), v[e]) for e in range(v.shape[0])]
    return [((l,), v)]


def leaf_norms(s: Spec, flat: torch.Tensor,
               minus_seed: Optional[int] = None) -> Dict[str, float]:
    """The L2 norm of every per-layer leaf of ``flat``; with
    ``minus_seed``, of its change from the weights drawn from that seed,
    which are drawn again one slice at a time."""
    out = {}
    for name, v in leaf_views(s, flat):
        sq = 0.0
        for idx, sub in _leaf_slices(s, name, v):
            if minus_seed is not None:
                sub = sub - draw(s, name.partition("@")[0], idx, minus_seed,
                                 v.device, torch.float32)
            sq += float(torch.linalg.vector_norm(
                sub, dtype=torch.float64)) ** 2
        out[name] = math.sqrt(sq)
    return out


def leaf_diff_norms(s: Spec, got: torch.Tensor, scale: float,
                    want: torch.Tensor) -> Dict[str, float]:
    """The L2 norm of ``scale * got - want`` on every per-layer leaf, with
    ``got`` (on the host or the card) brought to ``want``'s device a leaf
    at a time."""
    out = {}
    for (name, g), (_, w) in zip(leaf_views(s, got), leaf_views(s, want)):
        d = g.to(w.device, torch.float32) * scale - w
        out[name] = float(torch.linalg.vector_norm(d, dtype=torch.float64))
    return out
