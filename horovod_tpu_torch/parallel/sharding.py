"""Path-based partition rules: map a model's parameters onto the mesh.

Counterpart of :mod:`horovod_tpu.parallel.sharding`, the GSPMD analog of
per-tensor dispatch: parameters are placed on the mesh as ``DTensor``
and DTensor's propagation inserts the all-gathers, reduce-scatters and
all-reduces where XLA inserts them.  The rules are the JAX package's
own, (regex, PartitionSpec) pairs written against the flax layout:
"/"-joined flax paths and the per-dimension axes of flax shapes.
:func:`infer_shardings` maps each of this package's parameter names and
shapes onto that layout (what ``convert_flax_gpt_params`` and
``convert_flax_bert_params`` undo): a flax dense kernel ``[in, out]``
is an ``nn.Linear`` weight ``[out, in]``, and attention's
``[H, heads, head_dim]`` / ``[heads, head_dim, H]`` kernels have their
head dims flattened into one.  The optimizer's moments take their
parameter's placement, so the rules shard them too.
"""

import re
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch
from torch import nn
from torch.distributed.tensor import distribute_tensor

from .mesh import MeshLike, NamedSharding, P, PartitionSpec, mesh_shape

Rules = Sequence[Tuple[str, PartitionSpec]]


def _transformer_partition_rules(tp: str, fsdp: Optional[str],
                                 extra: Rules = ()) -> Rules:
    """Megatron-style tensor parallelism shared by both transformer
    families (models/bert.py naming == models/gpt.py naming): QKV
    projections column-parallel over heads, attention output
    row-parallel, MLP in column- / out row-parallel, embeddings
    vocab-sharded.  ``extra`` prepends family-specific rules."""
    f = fsdp  # optional second sharding axis (ZeRO-3 style)
    return [
        *extra,
        (r"word_embeddings/embedding$", P(tp, f)),
        (r"position_embeddings/embedding$", P(None, f)),
        (r"attention/(query|key|value)/kernel$", P(f, tp, None)),
        (r"attention/(query|key|value)/bias$", P(tp, None)),
        (r"attention/out/kernel$", P(tp, None, f)),
        (r"attention/out/bias$", P(None)),
        (r"intermediate/kernel$", P(f, tp)),
        (r"intermediate/bias$", P(tp)),
        (r"(layer_\d+/)output/kernel$", P(tp, f)),
        (r".*", P()),  # everything else (norms, small biases) replicated
    ]


def bert_partition_rules(tp: str = "tp",
                         fsdp: Optional[str] = None) -> Rules:
    """Tensor-parallel sharding for the BERT encoder family."""
    return _transformer_partition_rules(tp, fsdp, extra=[
        (r"token_type_embeddings/embedding$", P(None, fsdp)),
        (r"mlm_transform/kernel$", P(None, fsdp)),
        (r"mlm_bias$", P(tp)),
    ])


def gpt_partition_rules(tp: str = "tp",
                        fsdp: Optional[str] = None) -> Rules:
    """Tensor-parallel sharding for the GPT decoder family (the tied
    LM head inherits the embedding's vocab sharding)."""
    return _transformer_partition_rules(tp, fsdp)


def resnet_partition_rules(fsdp: Optional[str] = None) -> Rules:
    """ResNet is pure data parallel (conv kernels are small); optionally
    ZeRO-shard the dense head."""
    return [
        (r"Dense_0/kernel$", P(fsdp, None) if fsdp else P()),
        (r".*", P()),
    ]


def _fit_spec(spec: PartitionSpec, shape, mesh: MeshLike) -> PartitionSpec:
    """Adapt a rule's spec to a concrete leaf: drop axes the shape can't
    host (rank mismatch or non-divisible dims) so tiny dry-run shapes
    still compile."""
    sizes = mesh_shape(mesh)
    ndim = len(shape)
    parts = list(spec)
    if len(parts) > ndim:
        parts = parts[:ndim]
    while len(parts) < ndim:
        parts.append(None)
    fitted = []
    for dim, ax in zip(shape, parts):
        if ax is None:
            fitted.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        if any(a not in sizes for a in axes):
            # Rule names an axis this mesh doesn't have (e.g. tp rules on
            # a dp-only mesh): replicate that dimension.
            fitted.append(None)
            continue
        total = 1
        for a in axes:
            total *= sizes[a]
        fitted.append(ax if dim % total == 0 and dim > 0 else None)
    return P(*fitted)


# ---------------------------------------------------------------------------
# This package's parameters in the flax layout
# ---------------------------------------------------------------------------

_QKV = ("query", "key", "value")


def flax_layout(name: str, shape: Sequence[int],
                num_heads: Optional[int] = None,
                flax_path: Optional[Callable[[str], str]] = None
                ) -> Tuple[str, Tuple[int, ...], List[List[int]]]:
    """``(flax path, flax shape, dims)`` of the parameter ``name`` of
    shape ``shape``: ``dims[t]`` lists the flax dims (major first) that
    make up dim ``t`` of this package's tensor.  Attention kernels and
    biases need ``num_heads``.  ``flax_path`` gives the flax path of a
    name where the model names its modules otherwise than flax does
    (``ResNet.flax_path``); by default ``layers.N`` is flax's
    ``layer_N`` and every other module keeps its name."""
    parts = name.split(".")
    if flax_path is not None:
        *path, flax_leaf = flax_path(name).split("/")
    else:
        path = []
        i = 0
        while i < len(parts) - 1:
            if parts[i] == "layers" and parts[i + 1].isdigit():
                path.append(f"layer_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        mod, leaf = (path[-1] if path else ""), parts[-1]
        if not path:                               # e.g. mlm_bias
            flax_leaf = leaf
        elif leaf == "weight" and mod.endswith("embeddings"):
            flax_leaf = "embedding"
        elif leaf == "weight" and mod.endswith("norm"):
            flax_leaf = "scale"
        elif leaf in ("weight", "bias"):
            flax_leaf = "kernel" if leaf == "weight" else "bias"
        else:
            raise KeyError(f"no flax layout for parameter {name!r}")
    mod = path[-1] if path else ""
    shape = tuple(int(s) for s in shape)
    in_attention = len(path) >= 2 and path[-2] == "attention"

    def heads_split(n):
        if num_heads is None:
            raise ValueError(f"{name}: attention layouts need num_heads")
        return (num_heads, n // num_heads)

    fshape, dims = shape, [[d] for d in range(len(shape))]
    if flax_leaf == "kernel" and len(shape) == 4:  # OIHW -> HWIO
        out, inp, h, w = shape
        fshape, dims = (h, w, inp, out), [[3], [2], [0], [1]]
    elif flax_leaf == "kernel":
        out, inp = shape
        if in_attention and mod in _QKV:           # [H, heads, hd]
            fshape, dims = (inp, *heads_split(out)), [[1, 2], [0]]
        elif in_attention and mod == "out":        # [heads, hd, H]
            fshape, dims = (*heads_split(inp), out), [[2], [0, 1]]
        else:                                      # [in, out]
            fshape, dims = (inp, out), [[1], [0]]
    elif flax_leaf == "bias" and in_attention and mod in _QKV:
        fshape, dims = heads_split(shape[0]), [[0, 1]]  # [heads, hd]
    return "/".join(path + [flax_leaf]), tuple(fshape), dims


def _torch_spec(name: str, fspec: PartitionSpec,
                dims: List[List[int]]) -> PartitionSpec:
    """The flax-layout spec on this package's dims: a dim made of
    several flax dims takes the major one's axis; an axis on a minor
    one is not a contiguous shard and cannot be placed."""
    out = []
    for fdims in dims:
        major, *minor = fdims
        if any(fspec[m] is not None for m in minor):
            raise ValueError(f"{name}: spec {fspec} shards a minor dim "
                             f"of the flattened dims {fdims}")
        out.append(fspec[major])
    return P(*out)


def _named_shapes(module_or_state_dict) -> Tuple[Dict[str, Tuple[int, ...]],
                                                 Optional[int]]:
    if isinstance(module_or_state_dict, nn.Module):
        named = {n: tuple(p.shape)
                 for n, p in module_or_state_dict.named_parameters()}
        cfg = getattr(module_or_state_dict, "config", None)
        return named, getattr(cfg, "num_heads", None)
    return {n: tuple(t.shape) for n, t in module_or_state_dict.items()}, None


def infer_shardings(module_or_state_dict: Union[nn.Module,
                                                Mapping[str, torch.Tensor]],
                    mesh: MeshLike, rules: Rules, *,
                    num_heads: Optional[int] = None,
                    flax_path: Optional[Callable[[str], str]] = None
                    ) -> Dict[str, NamedSharding]:
    """``{parameter name: NamedSharding}`` by the first rule whose regex
    matches the parameter's flax path, fitted to its flax shape
    (:func:`_fit_spec`) and carried onto this package's layout.  A
    module gives its names, shapes, ``config.num_heads`` and its own
    ``flax_path`` where it has one; a state dict needs ``num_heads`` for
    attention and ``flax_path`` for a model whose names are not flax's
    (``models.resnet.flax_path``).  0-d tensors replicate."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    named, heads = _named_shapes(module_or_state_dict)
    heads = num_heads if num_heads is not None else heads
    if flax_path is None:
        flax_path = getattr(module_or_state_dict, "flax_path", None)
    out = {}
    for name, shape in named.items():
        if not shape:
            out[name] = NamedSharding(mesh, P())
            continue
        path, fshape, dims = flax_layout(name, shape, heads, flax_path)
        fspec = P(*([None] * len(fshape)))
        for pat, spec in compiled:
            if pat.search(path):
                fspec = _fit_spec(spec, fshape, mesh)
                break
        out[name] = NamedSharding(mesh, _torch_spec(name, fspec, dims))
    return out


def shard_tree(module_or_state_dict, mesh, rules: Rules, *,
               num_heads: Optional[int] = None,
               flax_path: Optional[Callable[[str], str]] = None):
    """Place a module's parameters (in place, as ``DTensor``
    parameters; returns the module) or a state dict's tensors (returns
    a new dict of ``DTensor``) on ``mesh`` by ``rules``.  Every rank
    holds the whole tensor and keeps its own shard of it."""
    shardings = infer_shardings(module_or_state_dict, mesh, rules,
                                num_heads=num_heads, flax_path=flax_path)
    if not isinstance(module_or_state_dict, nn.Module):
        return {n: shardings[n].distribute(t)
                for n, t in module_or_state_dict.items()}
    module = module_or_state_dict
    for name, p in list(module.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        placements = shardings[name].placements(p.dim())
        local = distribute_tensor(p.detach().to(mesh.device_type), mesh,
                                  placements, src_data_rank=None)
        owner.register_parameter(
            leaf, nn.Parameter(local, requires_grad=p.requires_grad))
    return module
