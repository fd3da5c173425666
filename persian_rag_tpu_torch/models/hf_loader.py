"""HuggingFace checkpoint import.

The counterpart of ``persian_rag_tpu.models.hf_loader``: maps the state
dicts of the three encoder architectures (BERT, DistilBERT, XLM-RoBERTa)
onto the JAX package's nested parameter tree, which
``models/convert.py`` (`encoder_params_from_flax`, `head_params_from_flax`)
turns into this package's state dicts.

Works from an in-memory state dict, a local HF checkpoint directory
(``model.safetensors`` or ``pytorch_model.bin``) or a local
sentence-transformers directory (``modules.json``: Pooling, Dense and
Normalize modules). Safetensors files are read by `read_safetensors`
below, so nothing but torch and numpy is needed. No network access is
assumed anywhere.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from persian_rag_tpu_torch.models.encoder import EncoderConfig


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:  # numpy has no bf16
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _dense(sd, prefix) -> Dict[str, np.ndarray]:
    return {
        "kernel": _np(sd[prefix + ".weight"]).T,
        "bias": _np(sd[prefix + ".bias"]),
    }


def _layer_norm(sd, prefix) -> Dict[str, np.ndarray]:
    return {
        "scale": _np(sd[prefix + ".weight"]),
        "bias": _np(sd[prefix + ".bias"]),
    }


def _strip_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Drop a leading model-name prefix (bert./roberta./distilbert./0.auto_model.)."""
    for prefix in ("0.auto_model.", "bert.", "roberta.", "distilbert."):
        if any(k.startswith(prefix) for k in sd):
            return {
                k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)
            }
    return sd


def params_from_bert(sd: Dict[str, Any], num_layers: int) -> Dict:
    """BERT / XLM-RoBERTa naming (encoder.layer.N....)."""
    sd = _strip_prefix(sd)
    emb = {
        "word_embeddings": {
            "embedding": _np(sd["embeddings.word_embeddings.weight"])
        },
        "position_embeddings": {
            "embedding": _np(sd["embeddings.position_embeddings.weight"])
        },
        "layer_norm": _layer_norm(sd, "embeddings.LayerNorm"),
    }
    if "embeddings.token_type_embeddings.weight" in sd:
        emb["token_type_embeddings"] = {
            "embedding": _np(sd["embeddings.token_type_embeddings.weight"])
        }
    params = {"embeddings": emb}
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": {
                "query": _dense(sd, f"{p}.attention.self.query"),
                "key": _dense(sd, f"{p}.attention.self.key"),
                "value": _dense(sd, f"{p}.attention.self.value"),
                "output": _dense(sd, f"{p}.attention.output.dense"),
            },
            "attention_norm": _layer_norm(sd, f"{p}.attention.output.LayerNorm"),
            "intermediate": _dense(sd, f"{p}.intermediate.dense"),
            "ffn_output": _dense(sd, f"{p}.output.dense"),
            "output_norm": _layer_norm(sd, f"{p}.output.LayerNorm"),
        }
    return params


def params_from_distilbert(sd: Dict[str, Any], num_layers: int) -> Dict:
    sd = _strip_prefix(sd)
    params = {
        "embeddings": {
            "word_embeddings": {
                "embedding": _np(sd["embeddings.word_embeddings.weight"])
            },
            "position_embeddings": {
                "embedding": _np(sd["embeddings.position_embeddings.weight"])
            },
            "layer_norm": _layer_norm(sd, "embeddings.LayerNorm"),
        }
    }
    for i in range(num_layers):
        p = f"transformer.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": {
                "query": _dense(sd, f"{p}.attention.q_lin"),
                "key": _dense(sd, f"{p}.attention.k_lin"),
                "value": _dense(sd, f"{p}.attention.v_lin"),
                "output": _dense(sd, f"{p}.attention.out_lin"),
            },
            "attention_norm": _layer_norm(sd, f"{p}.sa_layer_norm"),
            "intermediate": _dense(sd, f"{p}.ffn.lin1"),
            "ffn_output": _dense(sd, f"{p}.ffn.lin2"),
            "output_norm": _layer_norm(sd, f"{p}.output_layer_norm"),
        }
    return params


def params_from_state_dict(
    sd: Dict[str, Any], arch: str, num_layers: int
) -> Dict:
    if arch in ("bert", "roberta", "xlm-roberta"):
        return params_from_bert(sd, num_layers)
    if arch == "distilbert":
        return params_from_distilbert(sd, num_layers)
    raise ValueError(f"unknown architecture {arch!r}")


# ---------------------------------------------------------------------------
# Local checkpoint directory loading.
# ---------------------------------------------------------------------------

# safetensors dtype -> (numpy dtype of the stored bytes, torch view or None)
_SAFETENSORS_DTYPES = {
    "F32": (np.float32, None),
    "F16": (np.float16, None),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, None),
    "I32": (np.int32, None),
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as {name: CPU tensor}.

    The format: an 8-byte little-endian header length, a JSON header
    {name: {dtype, shape, data_offsets: [begin, end]}} (plus an optional
    ``__metadata__`` entry), then the data, whose offsets count from the
    end of the header. BF16 is read as uint16 and viewed as bfloat16."""
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    try:
        if len(buf) < 8:
            raise ValueError(f"{path}: too short for a safetensors file")
        (n_header,) = struct.unpack_from("<Q", buf, 0)
        header = json.loads(bytes(buf[8:8 + n_header]).decode("utf-8"))
        start = 8 + n_header
        out: Dict[str, torch.Tensor] = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = info["dtype"]
            if dtype not in _SAFETENSORS_DTYPES:
                raise ValueError(
                    f"{path}: tensor {name} has unsupported dtype {dtype}")
            np_dtype, view = _SAFETENSORS_DTYPES[dtype]
            begin, end = info["data_offsets"]
            shape = tuple(int(s) for s in info["shape"])
            count = int(np.prod(shape)) if shape else 1
            if end - begin != count * np.dtype(np_dtype).itemsize:
                raise ValueError(
                    f"{path}: tensor {name} has {end - begin} bytes for "
                    f"shape {shape} {dtype}")
            # copy: the tensor owns its memory once the map is closed
            arr = np.frombuffer(buf, np_dtype, count=count,
                                offset=start + begin).reshape(shape).copy()
            t = torch.from_numpy(arr)
            out[name] = t.view(view) if view is not None else t
        return out
    finally:
        buf.close()


def _read_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} from ``model.safetensors`` or, failing that,
    ``pytorch_model.bin`` (loaded with ``weights_only=True``)."""
    st_path = os.path.join(model_dir, "model.safetensors")
    pt_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    if os.path.exists(pt_path):
        return torch.load(pt_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no weights found under {model_dir}")


_ARCH_BY_MODEL_TYPE = {
    "bert": "bert",
    "roberta": "roberta",
    "xlm-roberta": "roberta",
    "distilbert": "distilbert",
}


def config_from_hf_dict(cfg: Dict[str, Any]) -> Tuple[EncoderConfig, str]:
    model_type = cfg.get("model_type", "bert")
    arch = _ARCH_BY_MODEL_TYPE.get(model_type)
    if arch is None:
        raise ValueError(f"unsupported model_type {model_type!r}")
    if arch == "distilbert":
        config = EncoderConfig(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["dim"],
            num_layers=cfg["n_layers"],
            num_heads=cfg["n_heads"],
            intermediate_size=cfg["hidden_dim"],
            max_position_embeddings=cfg["max_position_embeddings"],
            type_vocab_size=0,
            hidden_act=cfg.get("activation", "gelu"),
            pad_token_id=cfg.get("pad_token_id", 0),
        )
    else:
        roberta = model_type in ("roberta", "xlm-roberta")
        pad = cfg.get("pad_token_id", 1 if roberta else 0)
        config = EncoderConfig(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            intermediate_size=cfg["intermediate_size"],
            max_position_embeddings=cfg["max_position_embeddings"],
            type_vocab_size=cfg.get("type_vocab_size", 2),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
            hidden_act=cfg.get("hidden_act", "gelu"),
            position_offset=(pad + 1) if roberta else 0,
            pad_token_id=pad,
        )
    return config, arch


def load_hf_checkpoint(model_dir: str) -> Tuple[EncoderConfig, Dict]:
    """Load (config, parameter tree) from a local HF checkpoint directory."""
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        cfg = json.load(f)
    config, arch = config_from_hf_dict(cfg)
    sd = _read_state_dict(model_dir)
    params = params_from_state_dict(sd, arch, config.num_layers)
    return config, params


def load_sentence_transformer(
    model_dir: str,
) -> Tuple[EncoderConfig, Dict, Dict[str, Any]]:
    """Load a sentence-transformers model directory.

    Returns (encoder config, backbone parameter tree, pooling spec) where
    the pooling spec has keys: pooling ("mean"/"cls"), normalize (bool),
    projection_dim (int|None) and, if a Dense module exists, its weights
    under "projection_params".
    """
    config, params = load_hf_checkpoint(model_dir)
    pooling: Dict[str, Any] = {
        "pooling": "mean",
        "normalize": False,
        "projection_dim": None,
    }
    modules_path = os.path.join(model_dir, "modules.json")
    if os.path.exists(modules_path):
        with open(modules_path, encoding="utf-8") as f:
            modules = json.load(f)
        for mod in modules:
            mtype = mod.get("type", "")
            mpath = os.path.join(model_dir, mod.get("path", ""))
            if mtype.endswith("Pooling"):
                with open(
                    os.path.join(mpath, "config.json"), encoding="utf-8"
                ) as f:
                    pc = json.load(f)
                if pc.get("pooling_mode_cls_token"):
                    pooling["pooling"] = "cls"
                else:
                    pooling["pooling"] = "mean"
            elif mtype.endswith("Dense"):
                with open(
                    os.path.join(mpath, "config.json"), encoding="utf-8"
                ) as f:
                    dc = json.load(f)
                pooling["projection_dim"] = dc["out_features"]
                sd = _read_state_dict(mpath)
                key = "linear.weight" if "linear.weight" in sd else "weight"
                bkey = "linear.bias" if "linear.bias" in sd else "bias"
                pooling["projection_params"] = {
                    "projection": {
                        "kernel": _np(sd[key]).T,
                        "bias": _np(sd[bkey]),
                    }
                }
            elif mtype.endswith("Normalize"):
                pooling["normalize"] = True
    return config, params, pooling
