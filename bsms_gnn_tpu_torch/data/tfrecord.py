"""Pure-Python TFRecord → per-trajectory HDF5 converter, no TensorFlow
(counterpart of `bsms_gnn_tpu/data/tfrecord.py`).

A minimal protobuf wire-format walk: MeshGraphNets tfrecords store every
field as a `bytes_list` whose payload is decoded per `meta.json` (dtype,
shape), static fields are tiled over the trajectory, and each trajectory
becomes one `{index}.h5` under `{save_root}/{split}/` (a bad record is
skipped and the rest converted). Writing needs h5py, imported there.

Usage:
    python -m bsms_gnn_tpu_torch.data.tfrecord datasets=airfoil
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Dict, Iterator, List

import numpy as np

# ---------------------------------------------------------------------------
# TFRecord framing: {uint64 length, uint32 crc(length), payload, uint32 crc}.
# CRCs are not validated (the reference's TF reader also runs without check).
# ---------------------------------------------------------------------------


def read_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            if len(payload) < length:
                return
            f.read(4)  # payload crc
            yield payload


# ---------------------------------------------------------------------------
# Minimal protobuf wire parser for tf.train.Example:
#   Example{ features=1 } → Features{ map<string,Feature> feature=1 } →
#   entry{ key=1, value=2 } → Feature{ bytes_list=1 } → BytesList{ value=1 }.
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_example(record: bytes) -> Dict[str, List[bytes]]:
    """tf.train.Example → {feature name: [bytes values]}."""
    out: Dict[str, List[bytes]] = {}
    for field, _, val in _iter_fields(record):
        if field != 1:  # Example.features
            continue
        for f2, _, entry in _iter_fields(val):
            if f2 != 1:  # Features.feature map entry
                continue
            key = None
            values: List[bytes] = []
            for f3, _, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = v3.decode()
                elif f3 == 2:  # Feature
                    for f4, _, v4 in _iter_fields(v3):
                        if f4 == 1:  # bytes_list
                            for f5, _, v5 in _iter_fields(v4):
                                if f5 == 1:
                                    values.append(v5)
            if key is not None:
                out[key] = values
    return out


# ---------------------------------------------------------------------------
# meta.json-driven decoding.
# ---------------------------------------------------------------------------

_DTYPES = {
    "float32": np.float32,
    "float64": np.float64,
    "int32": np.int32,
    "int64": np.int64,
}


def decode_trajectory(example: Dict[str, List[bytes]], meta: dict) -> Dict[str, np.ndarray]:
    out = {}
    t_len = meta["trajectory_length"]
    for key, field in meta["features"].items():
        raw = b"".join(example[key])
        data = np.frombuffer(raw, dtype=_DTYPES[field["dtype"]])
        shape = list(field["shape"])  # may contain one -1 (node dim), like tf.reshape
        kind = field["type"]
        if kind == "static":
            data = data.reshape(shape)  # [1, N, d]
            data = np.tile(data, (t_len,) + (1,) * (data.ndim - 1))
        elif kind == "dynamic":
            data = data.reshape(shape)  # [T, N, d]
        elif kind == "dynamic_varlen":
            # Ragged per-frame cells: keep frame 0 tiled (the hierarchy
            # uses frame-0 connectivity).
            lengths = np.frombuffer(b"".join(example["length_" + key]), np.int32)
            first = data[: lengths[0] * shape[-1]].reshape(1, lengths[0], shape[-1])
            data = np.tile(first, (t_len, 1, 1))
        else:
            raise ValueError(f"invalid field type {kind}")
        out[key] = data
    return out


def convert_tfrecord_to_h5(dataset_dir: str, save_root: str, field_names: List[str]) -> None:
    import h5py

    with open(os.path.join(dataset_dir, "meta.json")) as f:
        meta = json.load(f)
    for split in ("train", "test", "valid"):
        src = os.path.join(dataset_dir, split + ".tfrecord")
        if not os.path.isfile(src):
            print(f"skip missing {src}", flush=True)
            continue
        split_dir = os.path.join(save_root, split)
        os.makedirs(split_dir, exist_ok=True)
        for index, record in enumerate(read_records(src)):
            try:
                traj = decode_trajectory(parse_example(record), meta)
                path = os.path.join(split_dir, f"{index}.h5")
                with h5py.File(path, "w") as f:
                    for key in field_names:
                        f.create_dataset(key, data=traj[key])
                print(f"wrote {path}", flush=True)
            except Exception as e:  # noqa: BLE001 (a bad record is skipped)
                print(f"skipped index {index}: {e}", flush=True)


def main() -> None:
    from bsms_gnn_tpu_torch.config import load_config

    cfg = load_config(sys.argv[1:])
    convert_tfrecord_to_h5(
        os.path.join(cfg.datasets.tf_dataset_dir, cfg.datasets.name),
        os.path.join(cfg.datasets.root, cfg.datasets.name),
        list(cfg.datasets.field_names),
    )


if __name__ == "__main__":
    main()
