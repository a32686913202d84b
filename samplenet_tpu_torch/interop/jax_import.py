"""Weights carried from the JAX package into the port.

Mirrors samplenet_tpu/interop/torch_import.py:105-240 without importing the
JAX package: `samplenet_state_dict_from_jax` maps the flax variable tree of
`samplenet_tpu.models.SampleNet` (nested dicts of numpy arrays) to the
reference torch key surface, exactly as `samplenet_to_torch(variables,
prefix=...)` does, and the port's SampleNet loads that state_dict as is;
an FC head without BN (the reconstruction track's sampler) has no bn_fc
keys. `pointnet_state_dict_from_jax` (vanilla or T-net) and
`autoencoder_state_dict_from_jax` map the classifier's and the
autoencoder's trees to the port's modules, `conv_decoder_state_dict_from_jax`
the ConvDecoder variant's, and `infer_pointnet_config`
reads the classifier's variant off its keys. `pcrnet_state_dict_from_jax`
maps PCRNet's tree to the keys `pcrnet_to_torch` writes, and
`infer_pcrnet_config` reads its bottleneck off them.
Conventions converted:

  * Dense kernel [in, out]      -> Conv1d weight [out, in, 1] / Linear [out, in]
  * BN scale/bias (params)      -> BatchNorm1d weight/bias
    BN mean/var (batch_stats)   -> running_mean/running_var
  * project/temperature ()      -> project._temperature

To serve a JAX orbax checkpoint, convert it in the JAX environment:
`samplenet_tpu.interop.samplenet_to_torch(variables)` and `torch.save` of
its values as tensors; `load_sampler_weights` reads that file.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch


def samplenet_state_dict_from_jax(
    variables: dict[str, Any], prefix: str = ""
) -> dict[str, np.ndarray]:
    """The reference torch state_dict (numpy values) of a flax SampleNet
    variable tree ({"params", "batch_stats"})."""
    p, s = variables["params"], variables.get("batch_stats", {})
    simp_p, simp_s = p["simplifier"], s.get("simplifier", {})
    sd: dict[str, np.ndarray] = {}

    convs = simp_p["convs"]
    n_conv = sum(1 for k in convs if k.startswith("dense_"))
    for i in range(n_conv):
        k = np.asarray(convs[f"dense_{i}"]["kernel"])
        sd[f"{prefix}conv{i+1}.weight"] = np.ascontiguousarray(k.T)[:, :, None]
        sd[f"{prefix}conv{i+1}.bias"] = np.asarray(convs[f"dense_{i}"]["bias"])
        sd[f"{prefix}bn{i+1}.weight"] = np.asarray(convs[f"bn_{i}"]["scale"])
        sd[f"{prefix}bn{i+1}.bias"] = np.asarray(convs[f"bn_{i}"]["bias"])
        bs = simp_s["convs"][f"bn_{i}"]
        sd[f"{prefix}bn{i+1}.running_mean"] = np.asarray(bs["mean"])
        sd[f"{prefix}bn{i+1}.running_var"] = np.asarray(bs["var"])
        sd[f"{prefix}bn{i+1}.num_batches_tracked"] = np.asarray(0)

    fcs = simp_p["fcs"]
    n_fc = sum(1 for k in fcs if k.startswith("dense_"))
    for i in range(n_fc):
        k = np.asarray(fcs[f"dense_{i}"]["kernel"])
        sd[f"{prefix}fc{i+1}.weight"] = np.ascontiguousarray(k.T)
        sd[f"{prefix}fc{i+1}.bias"] = np.asarray(fcs[f"dense_{i}"]["bias"])
        if f"bn_{i}" in fcs:
            sd[f"{prefix}bn_fc{i+1}.weight"] = np.asarray(fcs[f"bn_{i}"]["scale"])
            sd[f"{prefix}bn_fc{i+1}.bias"] = np.asarray(fcs[f"bn_{i}"]["bias"])
            bs = simp_s["fcs"][f"bn_{i}"]
            sd[f"{prefix}bn_fc{i+1}.running_mean"] = np.asarray(bs["mean"])
            sd[f"{prefix}bn_fc{i+1}.running_var"] = np.asarray(bs["var"])
            sd[f"{prefix}bn_fc{i+1}.num_batches_tracked"] = np.asarray(0)

    sd[f"{prefix}fc{n_fc+1}.weight"] = np.ascontiguousarray(
        np.asarray(simp_p["out"]["kernel"]).T)
    sd[f"{prefix}fc{n_fc+1}.bias"] = np.asarray(simp_p["out"]["bias"])
    sd[f"{prefix}project._temperature"] = np.asarray(
        p["project"]["temperature"], np.float32).reshape(())
    return sd


def pointnet_state_dict_from_jax(variables: dict[str, Any]
                                 ) -> dict[str, np.ndarray]:
    """The port's `PointNetClassifier` state_dict (numpy values) of a flax
    `PointNetClassifier` variable tree ({"params", "batch_stats"}), vanilla
    or T-net. Keys:

      convs/dense_i, convs/bn_i  -> conv{i+1}.weight [out, in, 1],
                                    conv{i+1}.bias, bn{i+1}.weight/bias/
                                    running_mean/running_var/
                                    num_batches_tracked  (vanilla)
      tnet_input, tnet_feature   -> tnet_*.convs.conv{i+1}/bn{i+1}.*,
        (convs, fc_i, bn_i,         tnet_*.fc_i.weight [out, in] / .bias,
         transform)                 tnet_*.bn_i.*, tnet_*.transform.*
      convs_a, convs_b           -> convs_a.conv{i+1}.*, convs_a.bn{i+1}.*,
                                    convs_b.* (T-net)
      fc1, bn_fc1, fc2, bn_fc2   -> fc1.weight [out, in], fc1.bias,
                                    bn_fc1.*, fc2.*, bn_fc2.*
      fc3                        -> fc3.weight [num_classes, 256], fc3.bias
    """
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, np.ndarray] = {}

    def bn(name: str, params: dict, stats: dict) -> None:
        sd[f"{name}.weight"] = np.asarray(params["scale"])
        sd[f"{name}.bias"] = np.asarray(params["bias"])
        sd[f"{name}.running_mean"] = np.asarray(stats["mean"])
        sd[f"{name}.running_var"] = np.asarray(stats["var"])
        sd[f"{name}.num_batches_tracked"] = np.asarray(0)

    def dense(name: str, params: dict) -> None:
        sd[f"{name}.weight"] = np.ascontiguousarray(
            np.asarray(params["kernel"]).T)
        sd[f"{name}.bias"] = np.asarray(params["bias"])

    def point_mlp(prefix: str, params: dict, stats: dict) -> None:
        for i in range(sum(1 for k in params if k.startswith("dense_"))):
            dense(f"{prefix}conv{i+1}", params[f"dense_{i}"])
            sd[f"{prefix}conv{i+1}.weight"] = \
                sd[f"{prefix}conv{i+1}.weight"][:, :, None]
            bn(f"{prefix}bn{i+1}", params[f"bn_{i}"], stats[f"bn_{i}"])

    if "tnet_input" in p:
        for tnet in ("tnet_input", "tnet_feature"):
            tp, ts = p[tnet], s[tnet]
            point_mlp(f"{tnet}.convs.", tp["convs"], ts["convs"])
            for i in (0, 1):
                dense(f"{tnet}.fc_{i}", tp[f"fc_{i}"])
                bn(f"{tnet}.bn_{i}", tp[f"bn_{i}"], ts[f"bn_{i}"])
            dense(f"{tnet}.transform", tp["transform"])
        point_mlp("convs_a.", p["convs_a"], s["convs_a"])
        point_mlp("convs_b.", p["convs_b"], s["convs_b"])
    elif "convs" in p:
        point_mlp("", p["convs"], s["convs"])
    else:
        raise KeyError("not a PointNetClassifier tree (neither 'convs' nor "
                       "'tnet_input')")
    for i in (1, 2, 3):
        dense(f"fc{i}", p[f"fc{i}"])
        if i < 3:
            bn(f"bn_fc{i}", p[f"bn_fc{i}"], s[f"bn_fc{i}"])
    return sd


def infer_pointnet_config(sd: dict[str, Any]) -> dict[str, Any]:
    """Constructor kwargs of the port's `PointNetClassifier` read off a
    state_dict's keys and shapes: {"num_classes", "use_tnets"}."""
    if "fc3.weight" not in sd:
        raise KeyError("no fc3.weight in the state_dict: not a "
                       "PointNetClassifier")
    return {"num_classes": int(sd["fc3.weight"].shape[0]),
            "use_tnets": any(k.startswith("tnet_input.") for k in sd)}


def autoencoder_state_dict_from_jax(variables: dict[str, Any]
                                    ) -> dict[str, np.ndarray]:
    """The port's `PointNetAE` state_dict (numpy values) of a flax
    `PointNetAE` variable tree ({"params", "batch_stats"}). Keys:

      encoder/dense_i, encoder/bn_i -> encoder.conv{i+1}.weight [out, in, 1],
                                       encoder.conv{i+1}.bias,
                                       encoder.bn{i+1}.weight/bias/
                                       running_mean/running_var/
                                       num_batches_tracked
      dec_0, dec_1, dec_out         -> dec_0.weight [out, in], dec_0.bias, ...
    """
    p, s = variables["params"], variables.get("batch_stats", {})
    enc, enc_s = p["encoder"], s.get("encoder", {})
    sd: dict[str, np.ndarray] = {}
    for i in range(sum(1 for k in enc if k.startswith("dense_"))):
        k = np.asarray(enc[f"dense_{i}"]["kernel"])
        sd[f"encoder.conv{i+1}.weight"] = np.ascontiguousarray(k.T)[:, :, None]
        sd[f"encoder.conv{i+1}.bias"] = np.asarray(enc[f"dense_{i}"]["bias"])
        sd[f"encoder.bn{i+1}.weight"] = np.asarray(enc[f"bn_{i}"]["scale"])
        sd[f"encoder.bn{i+1}.bias"] = np.asarray(enc[f"bn_{i}"]["bias"])
        sd[f"encoder.bn{i+1}.running_mean"] = np.asarray(
            enc_s[f"bn_{i}"]["mean"])
        sd[f"encoder.bn{i+1}.running_var"] = np.asarray(
            enc_s[f"bn_{i}"]["var"])
        sd[f"encoder.bn{i+1}.num_batches_tracked"] = np.asarray(0)
    for name in sorted(k for k in p if k.startswith("dec_")):
        sd[f"{name}.weight"] = np.ascontiguousarray(
            np.asarray(p[name]["kernel"]).T)
        sd[f"{name}.bias"] = np.asarray(p[name]["bias"])
    return sd


def conv_decoder_state_dict_from_jax(variables: dict[str, Any]
                                    ) -> dict[str, np.ndarray]:
    """The port's `ConvDecoder` state_dict (numpy values) of a flax
    `ConvDecoder` variable tree ({"params", "batch_stats"} without BN
    only "params"). Keys:

      expand, out                  -> expand.weight [out, in], .bias, out.*
      convs/dense_i, convs/bn_i    -> convs.conv{i+1}.weight [out, in, 1],
                                      convs.conv{i+1}.bias, convs.bn{i+1}.*
    """
    p, s = variables["params"], variables.get("batch_stats", {})
    convs, convs_s = p["convs"], s.get("convs", {})
    sd: dict[str, np.ndarray] = {}
    for name in ("expand", "out"):
        sd[f"{name}.weight"] = np.ascontiguousarray(
            np.asarray(p[name]["kernel"]).T)
        sd[f"{name}.bias"] = np.asarray(p[name]["bias"])
    for i in range(sum(1 for k in convs if k.startswith("dense_"))):
        k = np.asarray(convs[f"dense_{i}"]["kernel"])
        sd[f"convs.conv{i+1}.weight"] = np.ascontiguousarray(k.T)[:, :, None]
        sd[f"convs.conv{i+1}.bias"] = np.asarray(convs[f"dense_{i}"]["bias"])
        if f"bn_{i}" in convs:
            sd[f"convs.bn{i+1}.weight"] = np.asarray(convs[f"bn_{i}"]["scale"])
            sd[f"convs.bn{i+1}.bias"] = np.asarray(convs[f"bn_{i}"]["bias"])
            sd[f"convs.bn{i+1}.running_mean"] = np.asarray(
                convs_s[f"bn_{i}"]["mean"])
            sd[f"convs.bn{i+1}.running_var"] = np.asarray(
                convs_s[f"bn_{i}"]["var"])
            sd[f"convs.bn{i+1}.num_batches_tracked"] = np.asarray(0)
    return sd


def pcrnet_state_dict_from_jax(variables: dict[str, Any]
                               ) -> dict[str, np.ndarray]:
    """The port's `PCRNet` state_dict (numpy values) of a flax `PCRNet`
    variable tree ({"params"}), with the keys and layouts of
    samplenet_tpu/interop/torch_import.py:285-306 (`pcrnet_to_torch`):

      feat/convs/dense_i -> feat.conv{i+1}.weight [out, in, 1], .bias
      fc_j               -> fc{j+1}.weight [out, in], .bias
      twist              -> fc{n_fc+1}.weight [7, 256], .bias
    """
    p = variables["params"]
    sd: dict[str, np.ndarray] = {}
    convs = p["feat"]["convs"]
    for i in range(sum(1 for k in convs if k.startswith("dense_"))):
        k = np.asarray(convs[f"dense_{i}"]["kernel"])
        sd[f"feat.conv{i+1}.weight"] = np.ascontiguousarray(k.T)[:, :, None]
        sd[f"feat.conv{i+1}.bias"] = np.asarray(convs[f"dense_{i}"]["bias"])
    n_fc = sum(1 for k in p if k.startswith("fc_"))
    for j in range(n_fc):
        sd[f"fc{j+1}.weight"] = np.ascontiguousarray(
            np.asarray(p[f"fc_{j}"]["kernel"]).T)
        sd[f"fc{j+1}.bias"] = np.asarray(p[f"fc_{j}"]["bias"])
    sd[f"fc{n_fc+1}.weight"] = np.ascontiguousarray(
        np.asarray(p["twist"]["kernel"]).T)
    sd[f"fc{n_fc+1}.bias"] = np.asarray(p["twist"]["bias"])
    return sd


def infer_pcrnet_config(sd: dict[str, Any]) -> dict[str, Any]:
    """Constructor kwargs of the port's `PCRNet` read off a state_dict:
    {"bottleneck_size"}, the last feature conv's width."""
    convs = sorted(int(m.group(1)) for k in sd
                   if (m := re.fullmatch(r"feat\.conv(\d+)\.weight", k)))
    if not convs or "fc1.weight" not in sd:
        raise KeyError("no feat.conv*.weight or fc1.weight in the "
                       "state_dict: not a PCRNet")
    return {"bottleneck_size": int(sd[f"feat.conv{convs[-1]}.weight"]
                                   .shape[0])}


def infer_samplenet_config(sd: dict[str, Any], prefix: str = ""
                           ) -> dict[str, Any]:
    """Constructor kwargs for the port's `SampleNet` read off the weight
    shapes of a reference-keyed state_dict (torch_import.py:105-137)."""
    convs = sorted(
        int(m.group(1)) for k in sd
        if (m := re.fullmatch(re.escape(prefix) + r"conv(\d+)\.weight", k)))
    if not convs:
        raise KeyError(f"no {prefix}conv*.weight keys in the state_dict")
    widths = [sd[f"{prefix}conv{i}.weight"].shape[0] for i in convs]
    fcs = sorted(
        int(m.group(1)) for k in sd
        if (m := re.fullmatch(re.escape(prefix) + r"fc(\d+)\.weight", k)))
    fc_widths = [sd[f"{prefix}fc{i}.weight"].shape[0] for i in fcs[:-1]]
    out_dim = sd[f"{prefix}fc{fcs[-1]}.weight"].shape[0]
    if out_dim % 3:
        raise ValueError(f"final FC emits {out_dim} values; expected 3*m")
    return {
        "num_out_points": out_dim // 3,
        "bottleneck_size": widths[-1],
        "conv_widths": tuple(widths[:-1]),
        "fc_widths": tuple(fc_widths),
        "fc_bn": any(k.startswith(f"{prefix}bn_fc") for k in sd),
    }


def load_sampler_weights(path: str) -> dict[str, torch.Tensor]:
    """A sampler state_dict from a .pth file: a bare state_dict or one under
    "model", with DataParallel "module." prefixes stripped and, where the
    file is a joint SP-PCRNet checkpoint (registration/main.py:296), only
    the "sampler." entries kept, unprefixed."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    sd = {k.removeprefix("module."): torch.as_tensor(v)
          for k, v in obj.items() if hasattr(v, "shape")}
    if any(k.startswith("sampler.") for k in sd):
        sd = {k.removeprefix("sampler."): v for k, v in sd.items()
              if k.startswith("sampler.")}
    return sd
