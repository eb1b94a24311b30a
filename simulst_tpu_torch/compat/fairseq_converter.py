"""fairseq (PyTorch) checkpoint -> state_dict of the port's models
(counterpart of simulst_tpu/compat/fairseq_converter.py).

Loads reference checkpoints ({"cfg": ..., "model": state_dict}) into
s2t_emformer, MMA, CIF and the transducer for parity evaluation
(exp/5_parity_eval.sh).  fairseq names map straight onto the port's
parameter names (the JAX pytree paths joined with dots), with these
layouts:

  torch Linear (out, in)            -> (in, out)              [transpose]
  torch Conv1d (Cout, Cin/g, K)     -> the same               [copy]
  weight-norm conv-pos g (1, 1, K)  -> the same               [copy]
  fairseq ConvTBC (K, Cin, Cout)    -> (Cout, Cin, K)         [permute 2,1,0]
  LayerNorm weight / bias           -> scale / bias

The reference's surgical rules are kept: CTC and CIF projections absent on
either side are dropped (the model keeps its init, with a warning); the
legacy decoder.ctc_layer becomes encoder.ctc_layer; wait-k checkpoints
without soft projections tie them to the monotonic ones.  Every value is
checked against the parameter's shape and loaded as float32.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)


def load_fairseq_checkpoint(path: str):
    """(state dict as numpy arrays, the checkpoint's cfg or None)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt["model"] if "model" in ckpt else ckpt
    return ({k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
             for k, v in state.items()},
            ckpt.get("cfg") if isinstance(ckpt, dict) else None)


class _Target:
    """The model's state_dict being filled: set() checks the key and the
    shape."""

    def __init__(self, state: Dict[str, torch.Tensor]):
        self.state = state

    def __contains__(self, key: str) -> bool:
        return key in self.state

    def set(self, key: str, value: np.ndarray):
        if key not in self.state:
            raise KeyError(f"the model has no parameter {key}")
        old = self.state[key]
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: {tuple(old.shape)} "
                             f"vs {tuple(value.shape)}")
        self.state[key] = torch.tensor(np.asarray(value, np.float32),
                                       dtype=old.dtype)

    def linear(self, key: str, sd, name: str, bias: bool = True):
        self.set(key + ".weight", np.ascontiguousarray(sd[name + ".weight"].T))
        if bias and name + ".bias" in sd:
            self.set(key + ".bias", sd[name + ".bias"])

    def ln(self, key: str, sd, name: str):
        self.set(key + ".scale", sd[name + ".weight"])
        self.set(key + ".bias", sd[name + ".bias"])

    def mha(self, key: str, sd, name: str):
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.linear(f"{key}.{p}", sd, f"{name}.{p}")


def convert_encoder(t: _Target, sd, prefix: str = "encoder."):
    """The S2TEmformerEncoder's weights."""
    i = 0
    while f"encoder.subsample.layers.{i}.weight" in t:
        name = f"{prefix}subsample.conv_layers.{i}"
        t.set(f"encoder.subsample.layers.{i}.weight", sd[name + ".weight"])
        t.set(f"encoder.subsample.layers.{i}.bias", sd[name + ".bias"])
        i += 1
    conv = f"{prefix}embed_positions.conv"
    t.set("encoder.conv_pos.g", sd[conv + ".weight_g"])
    t.set("encoder.conv_pos.v", sd[conv + ".weight_v"])
    t.set("encoder.conv_pos.bias", sd[conv + ".bias"])
    i = 0
    while f"encoder.emformer.layers.{i}.ln_input.scale" in t:
        key = f"encoder.emformer.layers.{i}"
        name = f"{prefix}emformer_blocks.emformer_layers.{i}"
        for proj in ("emb_to_key_value", "emb_to_query", "out_proj"):
            t.linear(f"{key}.attention.{proj}", sd,
                     f"{name}.attention.{proj}")
        t.ln(f"{key}.pos_ff.ln", sd, f"{name}.pos_ff.0")
        t.linear(f"{key}.pos_ff.fc1", sd, f"{name}.pos_ff.1")
        t.linear(f"{key}.pos_ff.fc2", sd, f"{name}.pos_ff.4")
        t.ln(f"{key}.ln_input", sd, f"{name}.layer_norm_input")
        i += 1
    t.ln("encoder.emformer.final_ln", sd,
         f"{prefix}emformer_blocks.final_layer_norm")
    ctc = f"{prefix}ctc_layer.weight"
    if "encoder.ctc_layer.weight" in t and ctc in sd:
        t.set("encoder.ctc_layer.weight", np.ascontiguousarray(sd[ctc].T))
    elif "encoder.ctc_layer.weight" in t:
        logger.warning("checkpoint has no ctc_layer; keeping random init")
    elif ctc in sd:
        logger.warning("discarding checkpoint ctc_layer (model has none)")


def convert_decoder_layer(t: _Target, i: int, sd, name: str,
                          cross_attn: str = "standard"):
    key = f"decoder.layers.{i}"
    t.mha(f"{key}.self_attn", sd, f"{name}.self_attn")
    t.ln(f"{key}.self_attn_ln", sd, f"{name}.self_attn_layer_norm")
    if cross_attn in ("standard", "mma"):
        t.mha(f"{key}.encoder_attn", sd, f"{name}.encoder_attn")
    if cross_attn == "mma":
        for p in ("q_proj_soft", "k_proj_soft"):
            if f"{key}.encoder_attn.{p}.weight" not in t:
                continue
            src = p if f"{name}.encoder_attn.{p}.weight" in sd \
                else p.replace("_soft", "")     # wait-k ties soft to mono
            t.linear(f"{key}.encoder_attn.{p}", sd,
                     f"{name}.encoder_attn.{src}")
        eb = f"{name}.encoder_attn.energy_bias"
        if eb in sd and f"{key}.encoder_attn.energy_bias" in t:
            t.set(f"{key}.encoder_attn.energy_bias", sd[eb])
    elif cross_attn == "fake":
        t.linear(f"{key}.encoder_attn.q_proj", sd,
                 f"{name}.encoder_attn.q_proj", bias=False)
        t.linear(f"{key}.encoder_attn.k_proj", sd,
                 f"{name}.encoder_attn.k_proj")
        t.linear(f"{key}.encoder_attn.out_proj", sd,
                 f"{name}.encoder_attn.out_proj")
    if cross_attn != "none":
        t.ln(f"{key}.encoder_attn_ln", sd, f"{name}.encoder_attn_layer_norm")
    t.linear(f"{key}.fc1", sd, f"{name}.fc1")
    t.linear(f"{key}.fc2", sd, f"{name}.fc2")
    t.ln(f"{key}.final_ln", sd, f"{name}.final_layer_norm")


def convert_decoder(t: _Target, sd, cross_attn: str = "standard",
                    prefix: str = "decoder."):
    t.set("decoder.embed_tokens.weight", sd[f"{prefix}embed_tokens.weight"])
    i = 0
    while f"decoder.layers.{i}.final_ln.scale" in t:
        convert_decoder_layer(t, i, sd, f"{prefix}layers.{i}", cross_attn)
        i += 1
    t.ln("decoder.layer_norm", sd, f"{prefix}layer_norm")
    op = f"{prefix}output_projection.weight"
    if "decoder.output_projection.weight" in t and op in sd:
        t.set("decoder.output_projection.weight",
              np.ascontiguousarray(sd[op].T))


def convert_s2t_emformer(t: _Target, sd):
    convert_encoder(t, sd)
    convert_decoder(t, sd, cross_attn="standard")


def convert_mma(t: _Target, sd):
    convert_encoder(t, sd)
    convert_decoder(t, sd, cross_attn="mma")


def convert_cif(t: _Target, sd):
    sd = dict(sd)
    for k in list(sd):          # legacy: decoder.ctc_layer -> encoder's
        if k.startswith("decoder.ctc_layer."):
            sd["encoder." + k[len("decoder."):]] = sd.pop(k)
    convert_encoder(t, sd)
    # alpha_proj = [CausalConvTBC, LayerNorm, GELU, Dropout, Linear]
    name = "encoder.cif_layer.alpha_proj"
    if f"{name}.0.weight" in sd:
        t.set("cif.conv.weight", np.ascontiguousarray(
            np.transpose(sd[f"{name}.0.weight"], (2, 1, 0))))
        t.set("cif.conv.bias", sd[f"{name}.0.bias"])
        t.ln("cif.ln", sd, f"{name}.1")
        t.linear("cif.proj", sd, f"{name}.4")
    else:
        logger.warning("checkpoint has no cif_layer; keeping random init")
    cross = "fake"
    if any(k.startswith("decoder.layers.0.encoder_attn.v_proj") for k in sd):
        cross = "standard"      # the cif_infinite_lookback variant
    convert_decoder(t, sd, cross_attn=cross)


def convert_transducer(t: _Target, sd):
    """The label encoder (decoder layers without cross-attention) and the
    SimpleJoiner's projections."""
    convert_encoder(t, sd)
    convert_decoder(t, sd, cross_attn="none")
    t.linear("decoder.joiner.source_projection", sd,
             "decoder.joiner.source_projection")
    t.linear("decoder.joiner.target_projection", sd,
             "decoder.joiner.target_projection", bias=False)


CONVERTERS = {
    "s2t_emformer": convert_s2t_emformer,
    "mma": convert_mma,
    "cif": convert_cif,
    "transducer": convert_transducer,
}


def convert_state_dict(model_name: str, model: torch.nn.Module,
                       sd: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Load the fairseq state dict `sd` (numpy arrays) into `model`; the
    parameters it does not name keep their values."""
    t = _Target({k: v.detach().cpu() for k, v in model.state_dict().items()})
    CONVERTERS[model_name](t, sd)
    model.load_state_dict(t.state)
    return model


def convert(model_name: str, model: torch.nn.Module,
            checkpoint_path: str) -> torch.nn.Module:
    """Load a fairseq checkpoint file into `model` (s2t_emformer, mma, cif
    or transducer)."""
    sd, _ = load_fairseq_checkpoint(checkpoint_path)
    return convert_state_dict(model_name, model, sd)
