"""Import of the JAX package's CondUnet parameters (and its in-model
geometry embeds') into the port.

``params_to_state_dict`` turns a flax parameter tree of
``calodiffusion_tpu`` (nested dicts of numpy arrays, as ``model.init`` or a
checkpoint gives them) into the port's CondUnet ``state_dict``.  It is the
inverse of the layout maps of ``calodiffusion_tpu/tools/torch_import.py``:

- Conv3d        flax (kz, ka, kr, Cin, Cout) -> torch (Cout, Cin, kz, ka, kr)
- ConvTranspose flax (kz, ka, kr, Cin, Cout) -> torch (Cin, Cout, kz, ka, kr)
- Linear        flax (in, out)               -> torch (out, in)
- GroupNorm     scale -> weight, bias -> bias

Flax names submodules by per-type counters in call order
(``ResnetBlock_N`` or ``ConvNextBlock_N``, ``CheckpointResnetBlock_N`` or
``CheckpointConvNextBlock_N`` under ``REMAT``'s ``nn.remat``,
``LinearAttention_N``, ``PreNormResidual_N``, ``Conv3d_N``,
``Conv3dTranspose_N``), so the walk below follows the U-Net's call order
exactly as ``torch_import.import_condunet`` does.  The dense shower model
of an "FCN" embed (``ResNetDense_0``) goes through the cascade's writer.
``module_params_to_state_dict`` does the same for a standalone module
(``Attention``, ``LinearAttention``, ``PreNormResidual``, ``FCN``, and the
cascade's ``ResNetDense`` with its whitening statistics),
``layer_params_to_state_dict`` for the cascade's two-part tree
``{"base_model": ..., "layer_model": ...}`` and
``controlled_unet_params_to_state_dict`` for ControlNet's
``ControlledUnet`` (``control_model``, ``model``, ``gate_mu_i``).  ``dnn_params_to_state_dict``
and ``comparison_params_to_state_dict`` carry the evaluation networks (the
classifier's DNN, CNNCompare's ComparisonNetwork; Conv2d (kh, kw, Cin, Cout)
-> (Cout, Cin, kh, kw)).
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

    def convnext_block(self, path, base):
        """JAX ``ConvNextBlock`` (nn_modules.py:304-366) -> the port's, under
        the reference names ``torch_import._import_convnext_block`` reads."""
        n = self.node(path)
        self.sd[f"{base}.ds_conv.weight"] = _tensor(
            np.transpose(np.asarray(n["ds_kernel"]), (4, 3, 0, 1, 2)))
        self.sd[f"{base}.ds_conv.bias"] = _tensor(n["ds_bias"])
        if "Dense_0" in n:
            self.linear(path + ["Dense_0"], f"{base}.mlp.1")
        self.groupnorm(path + ["GroupNorm_0"], f"{base}.net.0")
        self.groupnorm(path + ["GroupNorm_1"], f"{base}.net.3")
        self.conv(path + ["Conv3d_0"], f"{base}.net.1")
        self.conv(path + ["Conv3d_1"], f"{base}.net.4")
        if "Conv3d_2" in n:
            self.conv(path + ["Conv3d_2"], f"{base}.res_conv")

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

    def res_net_dense(self, path, prefix):
        """JAX ``ResNetDense`` (nn_modules.py:825-852) -> the port's, under
        the reference names ``torch_import.import_resnet_dense`` reads."""
        self.cond_mlp(path + ["time_mlp"], f"{prefix}time_mlp", embed=False, unflatten=True)
        self.cond_mlp(path + ["cond_mlp"], f"{prefix}cond_mlp", embed=False, unflatten=False)
        self.linear(path + ["in_lay"], f"{prefix}in_lay")
        i = 0
        while f"ResDenseLayer_{i}" in self.node(path):
            layer = path + [f"ResDenseLayer_{i}"]
            for j, name in enumerate(("dense1.0", "embeder.1", "dense2.0")):
                self.linear(layer + [f"Dense_{j}"], f"{prefix}hidden_layers.{i}.{name}")
            i += 1
        self.linear(path + ["out_lay"], f"{prefix}out_lay")

    def fcn(self, path, prefix):
        """JAX ``FCN`` (nn_modules.py:855-881) -> the port's: the time and
        cond MLPs (sinusoidal where flax made two Dense layers, linear where
        three) and ``Dense_i`` -> ``fcn.{2 i}``."""
        for name, unflatten in (("time_mlp", True), ("cond_mlp", False)):
            embed = "Dense_2" not in self.node(path + [name])
            self.cond_mlp(path + [name], f"{prefix}{name}", embed=embed, unflatten=unflatten)
        i = 0
        while f"Dense_{i}" in self.node(path):
            self.linear(path + [f"Dense_{i}"], f"{prefix}fcn.{2 * i}")
            i += 1

    def attention(self, unet, k, base):
        self.groupnorm(unet + [f"PreNormResidual_{k}", "GroupNorm_0"], f"{base}.fn.norm")
        self.linear_attention(unet + [f"LinearAttention_{k}"], f"{base}.fn.fn.")

    def condunet(self, unet, prefix, config, down_only=False):
        """A flax CondUnet subtree at ``unet`` -> the port's CondUnet keys
        under ``prefix``, its blocks ResnetBlocks or ConvNextBlocks, under
        remat or not, as the tree names them; no time MLP where the tree
        has none (``no_time``); ``down_only``: the down path and the middle
        alone (ControlNet's control U-Net)."""
        tree = self.node(unet)
        block = next(b for b in ("ResnetBlock", "ConvNextBlock", "CheckpointResnetBlock",
                                 "CheckpointConvNextBlock") if f"{b}_0" in tree)
        write_block = self.convnext_block if "ConvNext" in block else self.resnet_block
        n_res = len(config["LAYER_SIZE_UNET"]) - 1
        block_attn = config.get("BLOCK_ATTN", False)
        mid_attn = config.get("MID_ATTN", False)

        self.conv(unet + ["init_conv"], f"{prefix}init_conv")
        if "time_mlp" in tree:
            self.cond_mlp(unet + ["time_mlp"], f"{prefix}time_mlp",
                          embed=config.get("TIME_EMBED", "sin") == "sin", unflatten=True)
        self.cond_mlp(unet + ["cond_mlp"], f"{prefix}cond_mlp",
                      embed=config.get("COND_EMBED", "sin") == "sin", unflatten=False)

        rb = attn = 0

        def blocks(base, count):
            nonlocal rb
            for j in range(count):
                write_block(unet + [f"{block}_{rb}"], f"{prefix}{base}{j}")
                rb += 1

        def attention(base):
            nonlocal attn
            self.attention(unet, attn, f"{prefix}{base}")
            attn += 1

        for i in range(n_res):
            blocks(f"downs.{i}.", 2)
            if block_attn:
                attention(f"downs_attn.{i}")
            if i < n_res - 1:
                self.conv(unet + [f"Conv3d_{i}"], f"{prefix}downs.{i}.2")

        write_block(unet + [f"{block}_{rb}"], f"{prefix}mid_block1")
        rb += 1
        if mid_attn:
            attention("mid_attn")
        write_block(unet + [f"{block}_{rb}"], f"{prefix}mid_block2")
        rb += 1
        if down_only:
            return

        for i in range(n_res):
            blocks(f"ups.{i}.", 2)
            if block_attn:
                attention(f"ups_attn.{i}")
            if i < n_res - 1:
                self.conv(unet + [f"Conv3dTranspose_{i}"], f"{prefix}ups.{i}.2",
                          transpose=True)

        write_block(unet + [f"{block}_{rb}"], f"{prefix}final_conv.0")
        self.conv(unet + ["final_conv"], f"{prefix}final_conv.1")


def _subtree(params):
    return params["params"] if "params" in params else params


def module_params_to_state_dict(params, module: str) -> dict[str, torch.Tensor]:
    """Flax params of a standalone ``Attention``, ``LinearAttention``,
    ``PreNormResidual`` (wrapping either) or ``ResNetDense`` of
    ``calodiffusion_tpu`` -> the port module's state_dict.  ``module`` names
    the module as the port builds it: "Attention", "LinearAttention",
    "PreNormResidual(Attention)", "PreNormResidual(LinearAttention)",
    "ResNetDense" or "FCN".  JAX ``Conv3d_0``/``Conv3d_1``/
    ``GroupNorm_0`` become ``to_qkv``/``to_out.0``/``to_out.1`` of a
    LinearAttention and ``to_qkv``/``to_out`` of an Attention; a
    PreNormResidual's ``GroupNorm_0`` and ``fn`` become ``fn.norm`` and
    ``fn.fn``.  A ResNetDense tree may carry the cascade's whitening
    statistics beside its params (``{"params": ..., "whiten": {"mean",
    "std"}}``, JAX layerdiffusion.py:75-100): they become ``whiten.mean``
    and ``whiten.std``."""
    w = _Writer(_subtree(params))
    if module == "ResNetDense":
        w.res_net_dense([], "")
        whiten = params.get("whiten") if isinstance(params, dict) else None
        if whiten is not None:
            w.sd["whiten.mean"] = _tensor(whiten["mean"])
            w.sd["whiten.std"] = _tensor(whiten["std"])
        return w.sd
    if module == "FCN":
        w.fcn([], "")
        return w.sd
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
    (``{"params": {"CondUnet_0": ...}}``) or the CondUnet subtree; a whole
    tree of an "FCN" embed holds ``ResNetDense_0`` instead, which becomes
    the port's ResNetDense keys (``time_mlp.*``, ``in_lay``, ...).  A whole
    tree's dataset-1 embed (``NN_embed``: ``enc_i`` (dim_r_out, dim_in) and
    ``dec_i`` (dim_in, dim_r_out), as torch's Linear weights) becomes
    ``NN_embed.encs.{i}.weight`` and ``NN_embed.decs.{i}.weight``, and a
    trainable HGCal GLaM's ``enc_mat`` (L, out, ncell) and ``dec_mat`` (L,
    ncell, out) ``NN_embed.embeder.mat`` and ``NN_embed.decoder.mat`` (the
    inverse of ``torch_import.py:249-252``; a frozen GLaM has no
    parameters)."""
    tree = _subtree(params)
    embed = tree.get("NN_embed", {})
    if "ResNetDense_0" in tree:
        w = _Writer(tree)
        w.res_net_dense(["ResNetDense_0"], "")
        return w.sd
    if "CondUnet_0" in tree:
        tree = tree["CondUnet_0"]
    w = _Writer(tree)
    i = 0
    while f"enc_{i}" in embed:
        w.sd[f"NN_embed.encs.{i}.weight"] = _tensor(embed[f"enc_{i}"])
        w.sd[f"NN_embed.decs.{i}.weight"] = _tensor(embed[f"dec_{i}"])
        i += 1
    if "enc_mat" in embed:
        w.sd["NN_embed.embeder.mat"] = _tensor(embed["enc_mat"])
        w.sd["NN_embed.decoder.mat"] = _tensor(embed["dec_mat"])
    w.condunet([], "", config)
    return w.sd


def layer_params_to_state_dict(params, config) -> dict[str, torch.Tensor]:
    """The JAX cascade's tree ``{"base_model": CondUnet params,
    "layer_model": ResNetDense params (+ "whiten")}`` -> the port
    ``LayerDiffusion``'s composite state_dict: ``base_model.<CondUnet
    key>``, ``layer_model.<ResNetDense key>`` and, where the stats exist,
    ``layer_model.whiten.mean`` / ``layer_model.whiten.std``."""
    sd = {f"base_model.{k}": v for k, v in params_to_state_dict(params["base_model"],
                                                              config).items()}
    layer = module_params_to_state_dict(params["layer_model"], "ResNetDense")
    sd.update({f"layer_model.{k}": v for k, v in layer.items()})
    return sd


def controlled_unet_params_to_state_dict(params, config) -> dict[str, torch.Tensor]:
    """The flax tree of ``calodiffusion_tpu.models.controlnet.ControlledUnet``
    (``control_model``, ``model``: two CondUnets; ``gate_mu_i``: f32
    scalars) -> the port ``ControlledUnet``'s state_dict
    (``control_model.<CondUnet key>``, ``model.<CondUnet key>``,
    ``gate_mu_i``); ``config`` gives the CondUnets' ``LAYER_SIZE_UNET``,
    ``BLOCK_ATTN``, ``MID_ATTN``, ``TIME_EMBED`` and ``COND_EMBED``."""
    tree = _subtree(params)
    w = _Writer(tree)
    w.condunet(["control_model"], "control_model.", config, down_only=True)
    w.condunet(["model"], "model.", config)
    i = 0
    while f"gate_mu_{i}" in tree:
        w.sd[f"gate_mu_{i}"] = _tensor(tree[f"gate_mu_{i}"])
        i += 1
    return w.sd


def dnn_params_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The flax tree of ``calodiffusion_tpu.evaluation.classifier.DNN``
    (``Dense_0`` .. ``Dense_n``) -> the port ``DNN``'s state_dict
    (``dense.{i}``; kernels (in, out) -> (out, in))."""
    tree = _subtree(params)
    w = _Writer(tree)
    for i in range(len(tree)):
        w.linear([f"Dense_{i}"], f"dense.{i}")
    return w.sd


def comparison_params_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The flax tree of ``calodiffusion_tpu.evaluation.evaluate.
    ComparisonNetwork`` -> the port ``ComparisonNetwork``'s state_dict:
    ``Conv_i`` -> ``convs.{i}`` (kernels (kh, kw, Cin, Cout) -> (Cout, Cin,
    kh, kw)), ``GroupNorm_i`` -> ``norms.{i}`` (scale -> weight),
    ``Dense_i`` -> ``dense.{i}`` ((in, out) -> (out, in))."""
    tree = _subtree(params)
    w = _Writer(tree)
    i = 0
    while f"Conv_{i}" in tree:
        n = tree[f"Conv_{i}"]
        w.sd[f"convs.{i}.weight"] = _tensor(np.transpose(np.asarray(n["kernel"]), (3, 2, 0, 1)))
        w.sd[f"convs.{i}.bias"] = _tensor(n["bias"])
        w.groupnorm([f"GroupNorm_{i}"], f"norms.{i}")
        i += 1
    for j in range(2):
        w.linear([f"Dense_{j}"], f"dense.{j}")
    return w.sd
