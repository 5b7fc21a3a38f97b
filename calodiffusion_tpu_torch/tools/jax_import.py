"""Import of the JAX package's CondUnet parameters into the port.

``params_to_state_dict`` turns a flax parameter tree of
``calodiffusion_tpu`` (nested dicts of numpy arrays, as ``model.init`` or a
checkpoint gives them) into the port's CondUnet ``state_dict``.  It is the
inverse of the layout maps of ``calodiffusion_tpu/tools/torch_import.py``:

- Conv3d        flax (kz, ka, kr, Cin, Cout) -> torch (Cout, Cin, kz, ka, kr)
- ConvTranspose flax (kz, ka, kr, Cin, Cout) -> torch (Cin, Cout, kz, ka, kr)
- Linear        flax (in, out)               -> torch (out, in)
- GroupNorm     scale -> weight, bias -> bias

Flax names submodules by per-type counters in call order
(``ResnetBlock_N``, ``LinearAttention_N``, ``PreNormResidual_N``,
``Conv3d_N``, ``Conv3dTranspose_N``), so the walk below follows the
U-Net's call order exactly as ``torch_import.import_condunet`` does.
``module_params_to_state_dict`` does the same for a standalone attention
module (``Attention``, ``LinearAttention``, ``PreNormResidual``).
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


class _Writer:
    def __init__(self, tree):
        self.tree = tree
        self.sd: dict[str, torch.Tensor] = {}

    def node(self, path):
        n = self.tree
        for k in path:
            n = n[k]
        return n

    def conv(self, path, base, transpose=False):
        n = self.node(path)
        perm = (3, 4, 0, 1, 2) if transpose else (4, 3, 0, 1, 2)
        self.sd[f"{base}.weight"] = _tensor(np.transpose(np.asarray(n["kernel"]), perm))
        if "bias" in n:
            self.sd[f"{base}.bias"] = _tensor(n["bias"])

    def linear(self, path, base):
        n = self.node(path)
        self.sd[f"{base}.weight"] = _tensor(np.asarray(n["kernel"]).T)
        self.sd[f"{base}.bias"] = _tensor(n["bias"])

    def groupnorm(self, path, base):
        n = self.node(path)
        self.sd[f"{base}.weight"] = _tensor(n["scale"])
        self.sd[f"{base}.bias"] = _tensor(n["bias"])

    def resnet_block(self, path, base):
        self.conv(path + ["Block_0", "Conv3d_0"], f"{base}.block1.proj")
        self.groupnorm(path + ["Block_0", "GroupNorm_0"], f"{base}.block1.norm")
        self.conv(path + ["Block_1", "Conv3d_0"], f"{base}.block2.proj")
        self.groupnorm(path + ["Block_1", "GroupNorm_0"], f"{base}.block2.norm")
        n = self.node(path)
        if "Dense_0" in n:
            self.linear(path + ["Dense_0"], f"{base}.mlp.1")
        if "Conv3d_0" in n:
            self.conv(path + ["Conv3d_0"], f"{base}.res_conv")

    def cond_mlp(self, path, base, embed, unflatten):
        idxs = [1, 3] if embed else ([1, 3, 5] if unflatten else [0, 2, 4])
        for j, idx in enumerate(idxs):
            self.linear(path + [f"Dense_{j}"], f"{base}.{idx}")

    # the attention modules: ``prefix`` is "" or ends in "."
    def linear_attention(self, path, prefix):
        self.conv(path + ["Conv3d_0"], f"{prefix}to_qkv")
        self.conv(path + ["Conv3d_1"], f"{prefix}to_out.0")
        self.groupnorm(path + ["GroupNorm_0"], f"{prefix}to_out.1")

    def softmax_attention(self, path, prefix):
        self.conv(path + ["Conv3d_0"], f"{prefix}to_qkv")
        self.conv(path + ["Conv3d_1"], f"{prefix}to_out")

    def attention(self, unet, k, base):
        self.groupnorm(unet + [f"PreNormResidual_{k}", "GroupNorm_0"], f"{base}.fn.norm")
        self.linear_attention(unet + [f"LinearAttention_{k}"], f"{base}.fn.fn.")


def _subtree(params):
    return params["params"] if "params" in params else params


def module_params_to_state_dict(params, module: str) -> dict[str, torch.Tensor]:
    """Flax params of a standalone ``Attention``, ``LinearAttention`` or
    ``PreNormResidual`` (wrapping either) of ``calodiffusion_tpu`` -> the
    port module's state_dict.  ``module`` names the module as the port
    builds it: "Attention", "LinearAttention", "PreNormResidual(Attention)"
    or "PreNormResidual(LinearAttention)".  JAX ``Conv3d_0``/``Conv3d_1``/
    ``GroupNorm_0`` become ``to_qkv``/``to_out.0``/``to_out.1`` of a
    LinearAttention and ``to_qkv``/``to_out`` of an Attention; a
    PreNormResidual's ``GroupNorm_0`` and ``fn`` become ``fn.norm`` and
    ``fn.fn``."""
    w = _Writer(_subtree(params))
    path, prefix, fn = [], "", module
    if module.startswith("PreNormResidual(") and module.endswith(")"):
        w.groupnorm(["GroupNorm_0"], "fn.norm")
        path, prefix, fn = ["fn"], "fn.fn.", module[len("PreNormResidual("):-1]
    writers = {"Attention": w.softmax_attention, "LinearAttention": w.linear_attention}
    if fn not in writers:
        raise ValueError(f"unknown module {module!r}")
    writers[fn](path, prefix)
    return w.sd


def params_to_state_dict(params, config) -> dict[str, torch.Tensor]:
    """Flax CondUnet params of ``calodiffusion_tpu`` -> the port's CondUnet
    state_dict (f32 CPU tensors).  ``params`` may be the whole tree
    (``{"params": {"CondUnet_0": ...}}``) or the CondUnet subtree."""
    tree = _subtree(params)
    if "CondUnet_0" in tree:
        tree = tree["CondUnet_0"]
    w = _Writer(tree)
    n_res = len(config["LAYER_SIZE_UNET"]) - 1
    block_attn = config.get("BLOCK_ATTN", False)
    mid_attn = config.get("MID_ATTN", False)

    w.conv(["init_conv"], "init_conv")
    w.cond_mlp(["time_mlp"], "time_mlp",
               embed=config.get("TIME_EMBED", "sin") == "sin", unflatten=True)
    w.cond_mlp(["cond_mlp"], "cond_mlp",
               embed=config.get("COND_EMBED", "sin") == "sin", unflatten=False)

    rb = attn = 0
    for i in range(n_res):
        for j in range(2):
            w.resnet_block([f"ResnetBlock_{rb}"], f"downs.{i}.{j}")
            rb += 1
        if block_attn:
            w.attention([], attn, f"downs_attn.{i}")
            attn += 1
        if i < n_res - 1:
            w.conv([f"Conv3d_{i}"], f"downs.{i}.2")

    w.resnet_block([f"ResnetBlock_{rb}"], "mid_block1")
    rb += 1
    if mid_attn:
        w.attention([], attn, "mid_attn")
        attn += 1
    w.resnet_block([f"ResnetBlock_{rb}"], "mid_block2")
    rb += 1

    for i in range(n_res):
        for j in range(2):
            w.resnet_block([f"ResnetBlock_{rb}"], f"ups.{i}.{j}")
            rb += 1
        if block_attn:
            w.attention([], attn, f"ups_attn.{i}")
            attn += 1
        if i < n_res - 1:
            w.conv([f"Conv3dTranspose_{i}"], f"ups.{i}.2", transpose=True)

    w.resnet_block([f"ResnetBlock_{rb}"], "final_conv.0")
    w.conv(["final_conv"], "final_conv.1")
    return w.sd
