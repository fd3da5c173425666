"""GGUF read/write for llama-family decoders (llama.cpp interop).

The counterpart of ``persian_rag_tpu.models.gguf``: the reference serves a
Llama-3.2-1B Q8_0 GGUF through llama.cpp, and this module lets the port
serve such a file (``TextGenerator.from_gguf``, ``gen-serve --gguf``) and
write one (``write_decoder_gguf``, ``gguf-export``). Block quantization
runs in torch, on the tensor's device (the card for the served path); the
Q8_0 blocks are byte-equal to the JAX package's.

Format notes (GGUF v3, little-endian):

* header ``GGUF`` magic, u32 version, u64 tensor count, u64 kv count;
  then metadata key/values, tensor infos (name, dims, ggml type, data
  offset), and an aligned data section (``general.alignment``, 32).
* ggml dimension order is innermost-first: a row-major ``(n_out, n_in)``
  weight is stored with ``ne = [n_in, n_out]`` and contiguous rows.
* Q8_0 blocks cover 32 consecutive in-row weights: one fp16 scale ``d``
  followed by 32 int8 quants, ``w = d * q`` (34 bytes / block). Q4_0 is
  one fp16 ``d`` plus 16 nibble bytes, ``w = d * (q - 8)``, where byte
  ``i`` holds weight ``i`` in its low nibble and weight ``i + 16`` in
  the high one (18 bytes / block).
* llama.cpp stores ``attn_q`` / ``attn_k`` with rotary halves PERMUTED
  relative to HF checkpoints (view the output dim as
  ``(heads, 2, head_dim/2)`` and swap the middle axes). The decoder here
  uses the HF half-split convention, so import applies the inverse
  permutation and export the forward one.

The embedded tokenizer (``tokenizer.ggml.*``) becomes a byte-level BPE
`TokenizerJSON` with the Llama-3 split (`GGUFTokenizer`).
"""
from __future__ import annotations

import dataclasses
import json
import mmap
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from persian_rag_tpu_torch.models.tokenizer_json import (
    LLAMA3_PATTERN,
    TokenizerJSON,
)

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
DEFAULT_ALIGNMENT = 32

# GGUF metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 = (
    range(13)
)
_SCALAR_FMT = {
    _U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I", _I32: "<i",
    _F32: "<f", _U64: "<Q", _I64: "<q", _F64: "<d",
}

# ggml tensor types (ggml.h enum)
GGML_F32 = 0
GGML_F16 = 1
GGML_Q4_0 = 2
GGML_Q8_0 = 8
GGML_BF16 = 30
# llama.cpp LLAMA_FTYPE values for general.file_type
_FTYPE = {"f32": 0, "f16": 1, "q8_0": 7, "q4_0": 2, "bf16": 32}

QK = 32  # ggml quantization block size (weights per block)


# ---------------------------------------------------------------------------
# block quant / dequant (torch, on the tensor's device)
# ---------------------------------------------------------------------------


def quantize_q8_0(x: torch.Tensor) -> torch.Tensor:
    """(n,) floats (n % 32 == 0) -> (n / 32 * 34,) uint8 q8_0 blocks.

    llama.cpp's quantize_row_q8_0: per-block symmetric absmax, d = amax /
    127 stored as fp16; the inverse scale uses the fp16-ROUNDED d, and
    the quants round half to even."""
    x = x.reshape(-1, QK).float()
    d16 = (x.abs().amax(dim=1) / 127.0).to(torch.float16)
    df = d16.float()
    inv = torch.where(df > 0, 1.0 / torch.where(df > 0, df, 1.0),
                      torch.zeros_like(df))
    q = torch.clamp(torch.round(x * inv[:, None]), -127, 127).to(torch.int8)
    return torch.cat([d16[:, None].view(torch.uint8), q.view(torch.uint8)],
                     dim=1).reshape(-1)


def dequantize_q8_0(raw: torch.Tensor, n: int) -> torch.Tensor:
    """(nbytes,) uint8 q8_0 blocks -> (n,) f32."""
    blocks = raw.reshape(-1, 34)
    d = blocks[:, :2].contiguous().view(torch.float16).float()  # (nb, 1)
    qs = blocks[:, 2:].contiguous().view(torch.int8).float()
    return (qs * d).reshape(-1)[:n]


def quantize_q4_0(x: torch.Tensor) -> torch.Tensor:
    """(n,) floats (n % 32 == 0) -> (n / 32 * 18,) uint8 q4_0 blocks, as
    llama.cpp's quantize_row_q4_0_ref: d = (the signed weight of largest
    magnitude) / -8 as fp16, q = min(15, trunc(w / d + 8.5))."""
    x = x.reshape(-1, QK).float()
    at = x.abs().argmax(dim=1, keepdim=True)
    d = torch.gather(x, 1, at)[:, 0] / -8.0
    inv = torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1.0),
                      torch.zeros_like(d))
    q = torch.clamp((x * inv[:, None] + 8.5).to(torch.int8), max=15)
    q = q.to(torch.uint8)
    packed = q[:, :16] | (q[:, 16:] << 4)
    return torch.cat([d.to(torch.float16)[:, None].view(torch.uint8), packed],
                     dim=1).reshape(-1)


def dequantize_q4_0(raw: torch.Tensor, n: int) -> torch.Tensor:
    """(nbytes,) uint8 q4_0 blocks -> (n,) f32."""
    blocks = raw.reshape(-1, 18)
    d = blocks[:, :2].contiguous().view(torch.float16).float()  # (nb, 1)
    qs = blocks[:, 2:]
    lo = (qs & 0x0F).to(torch.int8) - 8
    hi = (qs >> 4).to(torch.int8) - 8
    w = torch.cat([lo, hi], dim=1).float() * d
    return w.reshape(-1)[:n]


def _dequantize(data: torch.Tensor, ggml_type: int, shape: Tuple[int, ...]):
    n = int(np.prod(shape)) if shape else 1
    if ggml_type == GGML_F32:
        return data.view(torch.float32)[:n].reshape(shape)
    if ggml_type == GGML_F16:
        return data.view(torch.float16)[:n].float().reshape(shape)
    if ggml_type == GGML_BF16:
        return data.view(torch.bfloat16)[:n].float().reshape(shape)
    if ggml_type == GGML_Q8_0:
        return dequantize_q8_0(data, n).reshape(shape)
    if ggml_type == GGML_Q4_0:
        return dequantize_q4_0(data, n).reshape(shape)
    raise ValueError(f"unsupported ggml tensor type {ggml_type}")


def _tensor_nbytes(ggml_type: int, n: int) -> int:
    if ggml_type == GGML_F32:
        return 4 * n
    if ggml_type in (GGML_F16, GGML_BF16):
        return 2 * n
    if ggml_type == GGML_Q8_0:
        return 34 * (n // QK)
    if ggml_type == GGML_Q4_0:
        return 18 * (n // QK)
    raise ValueError(f"unsupported ggml tensor type {ggml_type}")


# ---------------------------------------------------------------------------
# rotary-half permutation (HF <-> GGML attn_q / attn_k layout)
# ---------------------------------------------------------------------------


def permute_hf_to_gguf(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """(n_out, n_in) HF q/k weight -> GGML layout: each head's output rows,
    HF-ordered [first halves | second halves], interleave into GGML's
    (pair, 2) order."""
    n_out = w.shape[0]
    return (w.reshape(n_head, 2, n_out // n_head // 2, *w.shape[1:])
            .transpose(1, 2).reshape(w.shape))


def permute_gguf_to_hf(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """Inverse of :func:`permute_hf_to_gguf`."""
    n_out = w.shape[0]
    return (w.reshape(n_head, n_out // n_head // 2, 2, *w.shape[1:])
            .transpose(1, 2).reshape(w.shape))


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GGUFTensor:
    name: str
    shape: Tuple[int, ...]  # torch order (outermost first)
    ggml_type: int
    offset: int  # relative to the data section start
    nbytes: int


class _Cursor:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def scalar(self, vtype: int):
        fmt = _SCALAR_FMT[vtype]
        (value,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return value

    def string(self) -> str:
        n = self.scalar(_U64)
        raw = bytes(self.buf[self.pos : self.pos + n])
        if len(raw) != n:
            raise ValueError("truncated GGUF string")
        self.pos += n
        return raw.decode("utf-8", errors="replace")

    def value(self, vtype: int):
        if vtype == _BOOL:
            return bool(self.scalar(_U8))
        if vtype == _STR:
            return self.string()
        if vtype == _ARR:
            elem_type = self.scalar(_U32)
            count = self.scalar(_U64)
            return [self.value(elem_type) for _ in range(count)]
        if vtype in _SCALAR_FMT:
            return self.scalar(vtype)
        raise ValueError(f"unknown GGUF value type {vtype}")


class GGUFFile:
    """Parsed GGUF: ``metadata`` dict, ``tensors`` by name, lazy data."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        cur = _Cursor(self._data)
        if bytes(self._data[:4]) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file (bad magic)")
        cur.pos = 4
        version = cur.scalar(_U32)
        if version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {version}")
        self.version = version
        n_tensors = cur.scalar(_U64)
        n_kv = cur.scalar(_U64)
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = cur.string()
            vtype = cur.scalar(_U32)
            self.metadata[key] = cur.value(vtype)
        self.tensors: Dict[str, GGUFTensor] = {}
        for _ in range(n_tensors):
            name = cur.string()
            n_dims = cur.scalar(_U32)
            ne = [cur.scalar(_U64) for _ in range(n_dims)]
            ggml_type = cur.scalar(_U32)
            offset = cur.scalar(_U64)
            shape = tuple(reversed(ne))  # ggml ne is innermost-first
            self.tensors[name] = GGUFTensor(
                name, shape, ggml_type,
                offset, _tensor_nbytes(ggml_type, int(np.prod(shape))),
            )
        align = int(self.metadata.get("general.alignment", DEFAULT_ALIGNMENT))
        self._data_start = (cur.pos + align - 1) // align * align

    def tensor(self, name: str, device=None) -> torch.Tensor:
        """The tensor as f32 on `device` (its bytes are copied there and
        dequantized there)."""
        info = self.tensors[name]
        data = np.frombuffer(self._data, np.uint8, count=info.nbytes,
                             offset=self._data_start + info.offset)
        # copy: the map may close before the tensor is dropped
        raw = torch.from_numpy(data.copy()).to(device or "cpu")
        return _dequantize(raw, info.ggml_type, info.shape)

    def close(self):
        self._data.close()


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _write_value(out: List[bytes], value, vtype: Optional[int] = None):
    if vtype is None:
        vtype = _infer_vtype(value)
    out.append(struct.pack("<I", vtype))
    _write_raw_value(out, value, vtype)


def _infer_vtype(value) -> int:
    if isinstance(value, bool):
        return _BOOL
    if isinstance(value, int):
        return _U32 if 0 <= value < 2**32 else _I64
    if isinstance(value, float):
        return _F32
    if isinstance(value, str):
        return _STR
    if isinstance(value, (list, tuple)):
        return _ARR
    if isinstance(value, np.ndarray):
        return _ARR
    if isinstance(value, np.integer):
        return _I32 if np.issubdtype(type(value), np.signedinteger) else _U32
    if isinstance(value, np.floating):
        return _F32
    raise TypeError(f"cannot infer GGUF type for {type(value)}")


def _write_raw_value(out: List[bytes], value, vtype: int):
    if vtype == _BOOL:
        out.append(struct.pack("<B", 1 if value else 0))
    elif vtype == _STR:
        raw = value.encode("utf-8")
        out.append(struct.pack("<Q", len(raw)))
        out.append(raw)
    elif vtype == _ARR:
        if isinstance(value, np.ndarray):
            # dtype picks the element type exactly (llama.cpp expects
            # token_type as an i32 array, for example)
            elem_type = {
                "int8": _I8, "uint8": _U8, "int16": _I16, "uint16": _U16,
                "int32": _I32, "uint32": _U32, "int64": _I64,
                "uint64": _U64, "float32": _F32, "float64": _F64,
            }[value.dtype.name]
            value = value.tolist()
        else:
            elem_type = _infer_vtype(value[0]) if len(value) else _STR
            # promote mixed int arrays conservatively
            if elem_type == _U32 and any(
                isinstance(v, int) and not 0 <= v < 2**32 for v in value
            ):
                elem_type = _I64
        out.append(struct.pack("<IQ", elem_type, len(value)))
        for v in value:
            _write_raw_value(out, v, elem_type)
    elif vtype in _SCALAR_FMT:
        out.append(struct.pack(_SCALAR_FMT[vtype], value))
    else:
        raise ValueError(f"unknown GGUF value type {vtype}")


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.array(x))  # a writable copy


def _encode_tensor(x, ggml_type: int) -> bytes:
    flat = _as_tensor(x).reshape(-1)
    if ggml_type == GGML_F32:
        out = flat.to(torch.float32)
    elif ggml_type == GGML_F16:
        out = flat.to(torch.float16)
    elif ggml_type == GGML_BF16:
        out = flat.to(torch.bfloat16).view(torch.int16)
    elif ggml_type == GGML_Q8_0:
        out = quantize_q8_0(flat)
    elif ggml_type == GGML_Q4_0:
        out = quantize_q4_0(flat)
    else:
        raise ValueError(f"writer does not support ggml type {ggml_type}")
    return out.cpu().numpy().tobytes()


def write_gguf(
    path: str,
    metadata: Dict[str, Any],
    tensors: Dict[str, Tuple[Any, int]],
    alignment: int = DEFAULT_ALIGNMENT,
) -> None:
    """Write a GGUF v3 file. ``tensors`` maps name -> (tensor or array,
    ggml_type); shapes are torch order (outermost first). Tensors are
    encoded one at a time (on their own device) as the file is written."""
    head: List[bytes] = [
        GGUF_MAGIC,
        struct.pack("<IQQ", GGUF_VERSION, len(tensors), len(metadata)),
    ]
    for key, value in metadata.items():
        _write_raw_value(head, key, _STR)
        _write_value(head, value)
    offset = 0
    pads: List[int] = []
    for name, (array, ggml_type) in tensors.items():
        shape = tuple(array.shape)
        nbytes = _tensor_nbytes(ggml_type, int(np.prod(shape)))
        ne = list(reversed(shape)) or [1]
        _write_raw_value(head, name, _STR)
        head.append(struct.pack("<I", len(ne)))
        head.append(struct.pack(f"<{len(ne)}Q", *ne))
        head.append(struct.pack("<IQ", ggml_type, offset))
        offset += nbytes
        pads.append((-offset) % alignment)
        offset += pads[-1]
    header = b"".join(head)
    with open(path, "wb") as f:
        f.write(header)
        f.write(b"\x00" * ((-len(header)) % alignment))
        for (array, ggml_type), pad in zip(tensors.values(), pads):
            f.write(_encode_tensor(array, ggml_type))
            f.write(b"\x00" * pad)


# ---------------------------------------------------------------------------
# decoder param tree <-> GGUF tensor mapping (llama architecture)
# ---------------------------------------------------------------------------


def config_from_gguf(gf: GGUFFile, **overrides):
    from persian_rag_tpu_torch.models.decoder import DecoderConfig

    md = gf.metadata
    if md.get("general.architecture") != "llama":
        raise ValueError(
            "only architecture=llama GGUF files are supported "
            f"(got {md.get('general.architecture')!r})"
        )
    heads = int(md["llama.attention.head_count"])
    fields = dict(
        vocab_size=int(
            md.get(
                "llama.vocab_size", gf.tensors["token_embd.weight"].shape[0]
            )
        ),
        hidden_size=int(md["llama.embedding_length"]),
        num_layers=int(md["llama.block_count"]),
        num_heads=heads,
        num_kv_heads=int(md.get("llama.attention.head_count_kv", heads)),
        intermediate_size=int(md["llama.feed_forward_length"]),
        max_position_embeddings=int(md.get("llama.context_length", 4096)),
        rms_norm_eps=float(
            md.get("llama.attention.layer_norm_rms_epsilon", 1e-5)
        ),
        rope_theta=float(md.get("llama.rope.freq_base", 10_000.0)),
        tie_word_embeddings="output.weight" not in gf.tensors,
    )
    fields.update(overrides)
    return DecoderConfig(**fields)


def params_from_gguf(source, device=None, **config_overrides):
    """GGUF path or GGUFFile -> (DecoderConfig, f32 parameter tree on
    `device`, dequantized there).

    attn_q / attn_k are un-permuted back to the HF half-split rotary
    layout the decoder uses; all (n_out, n_in) weights transpose to the
    ``kernel`` (n_in, n_out) convention.
    """
    gf = GGUFFile(source) if isinstance(source, str) else source
    config = config_from_gguf(gf, **config_overrides)

    def kernel(name: str, permute_heads: Optional[int] = None):
        w = gf.tensor(name, device)  # (n_out, n_in)
        if permute_heads is not None:
            w = permute_gguf_to_hf(w, permute_heads)
        return {"kernel": w.T.contiguous()}

    params: Dict[str, Any] = {
        "embed_tokens": {"embedding": gf.tensor("token_embd.weight", device)},
        "final_norm": {"scale": gf.tensor("output_norm.weight", device)},
    }
    for i in range(config.num_layers):
        p = f"blk.{i}"
        params[f"layer_{i}"] = {
            "input_norm": {"scale": gf.tensor(f"{p}.attn_norm.weight", device)},
            "post_attention_norm": {
                "scale": gf.tensor(f"{p}.ffn_norm.weight", device)
            },
            "attention": {
                "q_proj": kernel(f"{p}.attn_q.weight", config.num_heads),
                "k_proj": kernel(f"{p}.attn_k.weight", config.num_kv_heads),
                "v_proj": kernel(f"{p}.attn_v.weight"),
                "o_proj": kernel(f"{p}.attn_output.weight"),
            },
            "mlp": {
                "gate_proj": kernel(f"{p}.ffn_gate.weight"),
                "up_proj": kernel(f"{p}.ffn_up.weight"),
                "down_proj": kernel(f"{p}.ffn_down.weight"),
            },
        }
    if not config.tie_word_embeddings:
        params["lm_head"] = kernel("output.weight")
    return config, params


def write_decoder_gguf(
    path: str,
    config,
    params: Dict[str, Any],
    quant: str = "q8_0",
    name: str = "persian-rag-tpu-decoder",
    extra_metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Export a float decoder param tree (tensors or arrays, on any device:
    the blocks are quantized there) as a llama.cpp-servable GGUF.

    ``quant`` is the 2-D weight storage: "q8_0" (the reference's own
    serving precision), "f16", or "f32"; 1-D norm scales always stay
    f32 (llama.cpp convention). ``extra_metadata`` passes through
    verbatim AFTER the architecture keys — attach ``tokenizer.ggml.*``
    entries here so llama.cpp can tokenize.
    """
    if quant not in ("q8_0", "f16", "f32"):
        raise ValueError(f"unsupported export quant {quant!r}")
    embed = params.get("embed_tokens", {})
    if "embedding" not in embed:
        raise ValueError(
            "write_decoder_gguf needs a FLOAT param tree — export before "
            "quantize_decoder_params, or keep the pre-quantization "
            "params around (TextGenerator(quantize=...) re-quantizes "
            "from float at load)"
        )
    wtype = {"q8_0": GGML_Q8_0, "f16": GGML_F16, "f32": GGML_F32}[quant]

    def _f32(x):
        return _as_tensor(x).float()

    head_dim = config.hidden_size // config.num_heads
    metadata: Dict[str, Any] = {
        "general.architecture": "llama",
        "general.name": name,
        "general.file_type": _FTYPE[quant],
        "llama.block_count": config.num_layers,
        "llama.context_length": config.max_position_embeddings,
        "llama.embedding_length": config.hidden_size,
        "llama.feed_forward_length": config.intermediate_size,
        "llama.attention.head_count": config.num_heads,
        "llama.attention.head_count_kv": config.num_kv_heads,
        "llama.attention.layer_norm_rms_epsilon": float(config.rms_norm_eps),
        "llama.rope.freq_base": float(config.rope_theta),
        "llama.rope.dimension_count": head_dim,
        "llama.vocab_size": config.vocab_size,
    }
    metadata.update(extra_metadata or {})

    def w(tree, *keys):
        for key in keys:
            tree = tree[key]
        return _f32(tree)

    def kernel_t(tree, permute_heads: Optional[int] = None):
        if "kernel" not in tree:
            raise ValueError(
                "write_decoder_gguf needs a FLOAT param tree ({kernel} "
                "leaves) — export before quantize_decoder_params, or "
                "keep the pre-quantization params around"
            )
        out = _f32(tree["kernel"]).T  # (n_in, n_out) -> (n_out, n_in)
        if permute_heads is not None:
            out = permute_hf_to_gguf(out, permute_heads)
        return out.contiguous()

    tensors: Dict[str, Tuple[torch.Tensor, int]] = {
        "token_embd.weight": (w(params, "embed_tokens", "embedding"), wtype),
    }
    for i in range(config.num_layers):
        layer = params[f"layer_{i}"]
        att, mlp = layer["attention"], layer["mlp"]
        p = f"blk.{i}"
        tensors[f"{p}.attn_norm.weight"] = (
            w(layer, "input_norm", "scale"), GGML_F32,
        )
        tensors[f"{p}.attn_q.weight"] = (
            kernel_t(att["q_proj"], config.num_heads), wtype,
        )
        tensors[f"{p}.attn_k.weight"] = (
            kernel_t(att["k_proj"], config.num_kv_heads), wtype,
        )
        tensors[f"{p}.attn_v.weight"] = (kernel_t(att["v_proj"]), wtype)
        tensors[f"{p}.attn_output.weight"] = (kernel_t(att["o_proj"]), wtype)
        tensors[f"{p}.ffn_norm.weight"] = (
            w(layer, "post_attention_norm", "scale"), GGML_F32,
        )
        tensors[f"{p}.ffn_gate.weight"] = (kernel_t(mlp["gate_proj"]), wtype)
        tensors[f"{p}.ffn_up.weight"] = (kernel_t(mlp["up_proj"]), wtype)
        tensors[f"{p}.ffn_down.weight"] = (kernel_t(mlp["down_proj"]), wtype)
    tensors["output_norm.weight"] = (
        w(params, "final_norm", "scale"), GGML_F32,
    )
    if not config.tie_word_embeddings and "lm_head" in params:
        tensors["output.weight"] = (kernel_t(params["lm_head"]), wtype)
    write_gguf(path, metadata, tensors)


# ---------------------------------------------------------------------------
# embedded tokenizer (tokenizer.ggml.* metadata -> generation tokenizer)
# ---------------------------------------------------------------------------


class GGUFTokenizer:
    """Generation tokenizer rebuilt from GGUF ``tokenizer.ggml.*``
    metadata (BPE / "gpt2" model family — what Llama-3 GGUFs embed): a
    byte-level BPE with the Llama-3 split, control tokens (token_type 3)
    split out as special tokens.

    Satisfies the TextGenerator contract: ``encode(text) -> ids`` (BOS
    prepended), ``decode(ids) -> str`` (specials skipped), ``bos_id`` /
    ``eos_id`` / ``pad_id`` / ``vocab_size``.
    """

    def __init__(self, metadata: Dict[str, Any]):
        model = metadata.get("tokenizer.ggml.model")
        if model not in ("gpt2", "llama-bpe", "bpe"):
            raise ValueError(
                f"unsupported GGUF tokenizer model {model!r} (BPE only)"
            )
        tokens: List[str] = metadata["tokenizer.ggml.tokens"]
        merges: List[str] = metadata.get("tokenizer.ggml.merges", [])
        token_type: List[int] = metadata.get(
            "tokenizer.ggml.token_type", [1] * len(tokens)
        )
        vocab = {t: i for i, t in enumerate(tokens)}
        specials = [t for t, tt in zip(tokens, token_type) if tt == 3]
        self._tok = TokenizerJSON({
            "model": {"type": "BPE", "vocab": vocab,
                      "merges": [m.partition(" ")[::2] for m in merges],
                      "fuse_unk": False},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
                 "behavior": "Isolated", "invert": False},
                {"type": "ByteLevel", "add_prefix_space": False,
                 "use_regex": False}]},
            "decoder": {"type": "ByteLevel"},
            "added_tokens": [{"id": vocab[t], "content": t, "special": True,
                              "normalized": False} for t in dict.fromkeys(
                                  specials)],
        })
        self._special_ids = {
            i for i, tt in enumerate(token_type) if tt == 3
        }
        self.vocab_size = len(tokens)
        self.bos_id = int(metadata.get("tokenizer.ggml.bos_token_id", -1))
        self.eos_id = int(metadata.get("tokenizer.ggml.eos_token_id", -1))
        self.pad_id = int(
            metadata.get("tokenizer.ggml.padding_token_id", 0)
        )
        self.add_bos = bool(
            metadata.get("tokenizer.ggml.add_bos_token", True)
        )

    def encode(self, text: str, add_bos: Optional[bool] = None) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        use_bos = self.add_bos if add_bos is None else add_bos
        if use_bos and self.bos_id >= 0:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids) -> str:
        keep = [int(i) for i in ids if int(i) not in self._special_ids]
        return self._tok.decode(keep, skip_special_tokens=True)


def tokenizer_from_gguf(gf: GGUFFile) -> Optional[GGUFTokenizer]:
    """The embedded tokenizer, or None when the file carries none."""
    if "tokenizer.ggml.tokens" not in gf.metadata:
        return None
    return GGUFTokenizer(gf.metadata)


def tokenizer_metadata_from_hf(tokenizer_json_path: str) -> Dict[str, Any]:
    """HF fast-tokenizer ``tokenizer.json`` (BPE model) ->
    ``tokenizer.ggml.*`` metadata entries for :func:`write_decoder_gguf`,
    so exported files tokenize under llama.cpp."""
    with open(tokenizer_json_path, encoding="utf-8") as f:
        tj = json.load(f)
    model = tj.get("model", {})
    if model.get("type") != "BPE":
        raise ValueError(
            f"only BPE tokenizer.json exports are supported "
            f"(got {model.get('type')!r})"
        )
    vocab: Dict[str, int] = model["vocab"]
    size = max(vocab.values(), default=-1) + 1
    specials = {}
    for added in tj.get("added_tokens", []):
        specials[int(added["id"])] = (
            added["content"], bool(added.get("special", False))
        )
        size = max(size, int(added["id"]) + 1)
    tokens = [""] * size
    token_type = [1] * size
    for tok, idx in vocab.items():
        tokens[idx] = tok
    for idx, (content, special) in specials.items():
        tokens[idx] = content
        if special:
            token_type[idx] = 3  # ggml CONTROL
    merges = [
        m if isinstance(m, str) else " ".join(m)
        for m in model.get("merges", [])
    ]
    ids = {t: i for i, t in enumerate(tokens)}

    def first(*names: str) -> int:
        for n in names:
            if n in ids:
                return ids[n]
        return -1

    meta: Dict[str, Any] = {
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.pre": "llama-bpe",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.token_type": np.asarray(token_type, np.int32),
        "tokenizer.ggml.merges": merges,
    }
    bos = first("<|begin_of_text|>", "<s>", "<bos>")
    eos = first("<|eot_id|>", "<|end_of_text|>", "</s>", "<eos>")
    if bos >= 0:
        meta["tokenizer.ggml.bos_token_id"] = bos
    if eos >= 0:
        meta["tokenizer.ggml.eos_token_id"] = eos
    return meta
