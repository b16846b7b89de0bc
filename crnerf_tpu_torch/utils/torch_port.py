"""Convert the reference CR-NeRF PyTorch-Lightning checkpoints to the
flax layout (``crnerf_tpu/utils/torch_port.py``; numpy, with torch to read
the file).

A Lightning checkpoint's ``state_dict`` keys are prefixed by the
NeRFSystem's attribute names (``nerf_coarse``, ``nerf_fine``, ``enc_a``,
``enc_cont``, ``decoder``, ``implicit_mask``). ``convert_state_dict`` maps
them onto the flax params / batch-stats trees, the layout of
``weights.npz``; ``utils/weights.py`` carries that layout into the port's
modules. So a released checkpoint renders in the port:
``import_lightning_ckpt(ckpt, "weights.npz")``, then ``--ckpt_path
weights.npz``.

Layout conversions (torch -> flax):
- Linear  (out, in)          -> Dense kernel (in, out)
- Conv2d  (out, in, kh, kw)  -> Conv kernel (kh, kw, in, out)
- BatchNorm weight/bias      -> scale/bias params; running_mean/var ->
  batch_stats mean/var
- PReLU weight               -> alpha
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from crnerf_tpu_torch.utils.weights import save_npz

Tree = Dict[str, Any]


def _n(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _lin(sd: Tree, name: str) -> Tree:
    return {
        "kernel": _n(sd[f"{name}.weight"]).T,
        "bias": _n(sd[f"{name}.bias"]),
    }


def _conv(sd: Tree, name: str) -> Tree:
    p = {"kernel": _n(sd[f"{name}.weight"]).transpose(2, 3, 1, 0)}
    if f"{name}.bias" in sd:
        p["bias"] = _n(sd[f"{name}.bias"])
    return p


def _bn(sd: Tree, name: str) -> Tuple[Tree, Tree]:
    params = {"BatchNorm_0": {
        "scale": _n(sd[f"{name}.weight"]),
        "bias": _n(sd[f"{name}.bias"]),
    }}
    stats = {"BatchNorm_0": {
        "mean": _n(sd[f"{name}.running_mean"]),
        "var": _n(sd[f"{name}.running_var"]),
    }}
    return params, stats


def _prelu(sd: Tree, name: str) -> Tree:
    return {"alpha": _n(sd[f"{name}.weight"])}


def _sub(sd: Tree, prefix: str) -> Tree:
    pl = prefix + "."
    return {k[len(pl):]: v for k, v in sd.items() if k.startswith(pl)}


# ------------------------------------------------------------- NeRF MLP
def map_nerf_sigma(sd: Tree, depth: int = 8) -> Tree:
    """NeRF_sigma state dict -> NerfMLP params (trunk layers are
    Sequential(Linear, ReLU), hence the '.0')."""
    p = {
        f"xyz_encoding_{i}": _lin(sd, f"xyz_encoding_{i}.0")
        for i in range(1, depth + 1)
    }
    p["xyz_encoding_final"] = _lin(sd, "xyz_encoding_final")
    p["sigma"] = _lin(sd, "static_sigma.0")
    p["dir_encoding"] = _lin(sd, "dir_encoding.0")
    p["feature"] = _lin(sd, "static_rgb.0")
    return p


# --------------------------------------------------- appearance encoder
def map_encoder(sd: Tree) -> Tree:
    """encoder_sameoutputsize (linearStyleTransfer.py:208-276): conv1/conv7
    are plain 1x1 convs; conv2-6 sit inside reflection-pad wrappers on the
    flax side (hence Conv_0)."""
    p = {}
    for i in range(1, 8):
        conv = _conv(sd, f"conv{i}")
        p[f"conv{i}"] = conv if i in (1, 7) else {"Conv_0": conv}
    return p


# ------------------------------------------------------ style transform
def map_gram_cnn(sd: Tree) -> Tree:
    """CNN tower (linearStyleTransfer.py:6-37): convs Sequential indices
    0/2/4 are the conv layers (1/3 are ReLUs)."""
    return {
        "conv1": _conv(sd, "convs.0"),
        "conv2": _conv(sd, "convs.2"),
        "conv3": _conv(sd, "convs.4"),
        "fc": _lin(sd, "fc"),
    }


def map_mullayer(sd: Tree) -> Tree:
    return {
        "cnet": map_gram_cnn(_sub(sd, "cnet")),
        "snet": map_gram_cnn(_sub(sd, "snet")),
        "compress": _conv(sd, "compress"),
        "unzip": _conv(sd, "unzip"),
    }


def map_neural_renderer(sd: Tree) -> Tree:
    """NeuralRenderer at any n_blocks (nerf_decoder_stylenerf.py:239-291).

    Blur modules register a constant [1,2,1] ``.f`` buffer (line 108) that
    carries no learned state — dropped. n_blocks is inferred from the
    checkpoint's feat_layers indices (0 in the shipped featmap==img config)."""
    sd = {k: v for k, v in sd.items() if not k.endswith(".f")}

    def count(prefix: str) -> int:
        idx = {int(k.split(".")[1]) for k in sd if k.startswith(prefix + ".")}
        return max(idx) + 1 if idx else 0

    n_blocks = count("feat_layers")
    if count("feat_2_rgb_list") != n_blocks + 1:
        raise ValueError(
            f"inconsistent decoder checkpoint: {n_blocks} feat_layers but "
            f"{count('feat_2_rgb_list')} feat_2_rgb_list convs "
            f"(keys: {sorted(sd)})"
        )
    p = {"feat_2_rgb_0": _conv(sd, "feat_2_rgb_list.0")}
    for i in range(n_blocks):
        p[f"upsample_{i}"] = {
            "layer_1": _conv(sd, f"feat_upsample_list.{i}.layer_1"),
            "layer_2": _conv(sd, f"feat_upsample_list.{i}.layer_2"),
        }
        p[f"feat_{i}"] = _conv(sd, f"feat_layers.{i}")
        p[f"feat_2_rgb_{i + 1}"] = _conv(sd, f"feat_2_rgb_list.{i + 1}")
    return p


def map_stylenet(sd: Tree) -> Tree:
    return {
        "multi_net": map_mullayer(_sub(sd, "multi_net")),
        "decoder": map_neural_renderer(_sub(sd, "decoder")),
    }


# ----------------------------------------------------------------- CGNet
def _convbnprelu(sd: Tree, prefix: str) -> Tuple[Tree, Tree]:
    bn_p, bn_s = _bn(sd, f"{prefix}.bn")
    return (
        {
            "Conv_0": _conv(sd, f"{prefix}.conv"),
            "_Norm_0": bn_p,
            "PReLU_0": _prelu(sd, f"{prefix}.act"),
        },
        {"_Norm_0": bn_s},
    )


def _bnprelu(sd: Tree, prefix: str) -> Tuple[Tree, Tree]:
    bn_p, bn_s = _bn(sd, f"{prefix}.bn")
    return (
        {"_Norm_0": bn_p, "PReLU_0": _prelu(sd, f"{prefix}.act")},
        {"_Norm_0": bn_s},
    )


def _fglo(sd: Tree, prefix: str) -> Tree:
    return {
        "Dense_0": _lin(sd, f"{prefix}.fc.0"),
        "Dense_1": _lin(sd, f"{prefix}.fc.2"),
    }


def _cgblock_down(sd: Tree, prefix: str) -> Tuple[Tree, Tree]:
    p, s = {}, {}
    p["conv1x1"], s["conv1x1"] = _convbnprelu(sd, f"{prefix}.conv1x1")
    p["F_loc"] = _conv(sd, f"{prefix}.F_loc.conv")
    p["F_sur"] = _conv(sd, f"{prefix}.F_sur.conv")
    bn_p, bn_s = _bn(sd, f"{prefix}.bn")
    p["_Norm_0"], s["_Norm_0"] = bn_p, bn_s
    p["PReLU_0"] = _prelu(sd, f"{prefix}.act")
    p["reduce"] = _conv(sd, f"{prefix}.reduce.conv")
    p["FGlo_0"] = _fglo(sd, f"{prefix}.F_glo")
    return p, s


def _cgblock(sd: Tree, prefix: str) -> Tuple[Tree, Tree]:
    p, s = {}, {}
    p["conv1x1"], s["conv1x1"] = _convbnprelu(sd, f"{prefix}.conv1x1")
    p["F_loc"] = _conv(sd, f"{prefix}.F_loc.conv")
    p["F_sur"] = _conv(sd, f"{prefix}.F_sur.conv")
    p["bn_prelu"], s["bn_prelu"] = _bnprelu(sd, f"{prefix}.bn_prelu")
    p["FGlo_0"] = _fglo(sd, f"{prefix}.F_glo")
    return p, s


def map_cgnet(sd: Tree) -> Tuple[Tree, Tree]:
    """Context_Guided_Network (lightweight_seg.py:274-368). M/N (block
    counts) are inferred from the checkpoint's level2./level3. indices."""
    p, s = {}, {}
    for name in ("level1_0", "level1_1", "level1_2"):
        p[name], s[name] = _convbnprelu(sd, name)
    p["b1"], s["b1"] = _bnprelu(sd, "b1")
    p["level2_0"], s["level2_0"] = _cgblock_down(sd, "level2_0")

    def n_blocks(level: str) -> int:
        idx = {
            int(k.split(".")[1]) for k in sd if k.startswith(level + ".")
        }
        return max(idx) + 1 if idx else 0

    for i in range(n_blocks("level2")):
        p[f"level2_{i + 1}"], s[f"level2_{i + 1}"] = _cgblock(
            sd, f"level2.{i}"
        )
    p["bn_prelu_2"], s["bn_prelu_2"] = _bnprelu(sd, "bn_prelu_2")
    p["level3_0"], s["level3_0"] = _cgblock_down(sd, "level3_0")
    for i in range(n_blocks("level3")):
        p[f"level3_{i + 1}"], s[f"level3_{i + 1}"] = _cgblock(
            sd, f"level3.{i}"
        )
    p["bn_prelu_3"], s["bn_prelu_3"] = _bnprelu(sd, "bn_prelu_3")
    cls = _conv(sd, "classifier.0.conv")
    # the reference classifier conv has no bias; the flax one does
    cls.setdefault(
        "bias", np.zeros(cls["kernel"].shape[-1], np.float32)
    )
    p["classifier"] = cls
    return p, s


# ------------------------------------------------------------ top level
def convert_state_dict(
    sd: Tree,
    netdepth: int = 8,
    prefixes_to_ignore: Iterable[str] = ("loss",),
) -> Tuple[Tree, Tree]:
    """Full reference state_dict -> (params, batch_stats) trees keyed by
    the same submodule prefixes. Unknown prefixes raise
    (fail loud beats silently dropping weights)."""
    skip = set(prefixes_to_ignore)
    prefixes = {k.split(".", 1)[0] for k in sd} - skip
    params: Tree = {}
    stats: Tree = {}
    for prefix in sorted(prefixes):
        sub = _sub(sd, prefix)
        if prefix in ("nerf_coarse", "nerf_fine"):
            params[prefix] = map_nerf_sigma(sub, depth=netdepth)
        elif prefix in ("enc_a", "enc_cont"):
            params[prefix] = map_encoder(sub)
        elif prefix == "decoder":
            if any(k.startswith("multi_net.") for k in sub):
                params[prefix] = map_stylenet(sub)
            else:
                params[prefix] = map_neural_renderer(sub)
        elif prefix == "implicit_mask":
            params[prefix], stats[prefix] = map_cgnet(sub)
        else:
            raise ValueError(
                f"unknown checkpoint prefix {prefix!r} (known: nerf_coarse,"
                " nerf_fine, enc_a, enc_cont, decoder, implicit_mask; pass"
                " prefixes_to_ignore to skip)"
            )
    return params, stats


def load_lightning_ckpt(path: str) -> Tree:
    """Read a Lightning .ckpt (or a bare state_dict .pth) into a flat
    {key: tensor} dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt


def import_lightning_ckpt(path: str, out: str, netdepth: int = 8,
                          prefixes_to_ignore: Iterable[str] = ("loss",)
                          ) -> str:
    """A reference Lightning checkpoint -> ``weights.npz`` at ``out`` in the
    flax layout, which ``utils/weights.py`` ``load_into`` loads into the
    port's system (``--ckpt_path`` of the eval and serve apps)."""
    params, stats = convert_state_dict(load_lightning_ckpt(path), netdepth,
                                       prefixes_to_ignore)
    save_npz({"params": params, "batch_stats": stats}, out)
    return out
