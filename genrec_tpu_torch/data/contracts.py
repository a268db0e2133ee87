"""File contracts of the port: a copy of ``genrec_tpu/data/contracts.py``.

- ``course_rqvae_codes.npy`` holds an (N_items + 1, L + 1) int table: row i
  is dense item i (row 0 is padding), L RQ levels plus a collision-
  disambiguation digit (`RQ-VAE/infer.py:149-184`). Written beside it,
  ``*_mapping.json`` maps each row index to its code list.
- ``InteractionData`` is the in-memory form of ``user_item_interact.h5``
  (``user_id`` int32, ``user_profile`` vlen str, ``item_id_list`` vlen int32;
  read at `SASRec/data_vision.py:40-46`).
- ``course_item_embs.h5``: ``item_embs`` (N_items + 1, D) f32, row 0 the
  padding row, and a JSON ``meta`` string.
- ``user_profile_embs.h5``: ``user_embs`` (N, D) f32, row i is user i+1
  (indexed ``user_id - 1`` at `T5/data_vision.py:137`).
- ``prof_lvl{1,2,3}.h5``: ``user_id`` (N,) int32 and ``user_major_embs``
  (N, 5, 768) f32, the top-5 major vectors of each user at one level.
- ``tiger/{train,test}_dataset.h5``: ``user_id`` int32, ``history`` /
  ``target`` vlen int32 of flattened offset tokens
  (`RQVAE-T5/data_vision.py:8-11`).
- ``course_info.h5`` / ``course_id_map.h5`` / ``user_id_map.h5``: course
  text fields and original-id ↔ dense-id maps (`T5/data_vision.py:70-84`).
- ``recommendation_data.h5``: groups ``classes/``, ``interactions/``,
  ``students/`` (`Baseline/data_process.py:39-105`).

h5py is imported only by the functions that read or write it, so the rest
of the port runs without it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def write_codes(path: str, codes: np.ndarray, write_mapping_json: bool = True) -> None:
    """``course_rqvae_codes.npy`` + ``*_mapping.json`` (RQ-VAE/infer.py:173-184)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    codes = np.asarray(codes)
    np.save(path, codes)
    if write_mapping_json:
        mapping_file = path.replace(".npy", "_mapping.json")
        index_to_code = {i: c.tolist() for i, c in enumerate(codes)}
        with open(mapping_file, "w") as f:
            json.dump(index_to_code, f, indent=2)


def read_codes(path: str) -> np.ndarray:
    return np.load(path)


def _ensure_parent(path: str) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)


def _decode(arr) -> List[str]:
    """An H5 string array as Python strings."""
    return [s.decode("utf-8") if isinstance(s, bytes) else str(s) for s in arr]


def write_item_embs(path: str, item_embs: np.ndarray,
                    meta: Optional[Dict] = None) -> None:
    """Row 0 is the padding row (empty-text embedding in the reference)."""
    import h5py

    _ensure_parent(path)
    with h5py.File(path, "w") as f:
        f.create_dataset("item_embs", data=np.asarray(item_embs, dtype=np.float32),
                         compression="gzip")
        meta = dict(meta or {})
        meta.setdefault("dim", int(item_embs.shape[1]))
        f.create_dataset("meta", data=np.bytes_(json.dumps(meta, ensure_ascii=False)))


def read_item_embs(path: str):
    import h5py

    with h5py.File(path, "r") as f:
        embs = f["item_embs"][:].astype(np.float32)
        meta = {}
        if "meta" in f:
            raw = f["meta"][()]
            if isinstance(raw, bytes):
                meta = json.loads(raw.decode("utf-8"))
    return embs, meta


def write_user_embs(path: str, user_embs: np.ndarray) -> None:
    """Row i corresponds to user_id i+1 (contiguous 1-based users)."""
    import h5py

    _ensure_parent(path)
    with h5py.File(path, "w") as f:
        f.create_dataset("user_embs", data=np.asarray(user_embs, dtype=np.float32),
                         compression="gzip")


def read_user_embs(path: str) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        return f["user_embs"][:].astype(np.float32)


def write_prof_lvl(path: str, user_ids: np.ndarray, user_major_embs: np.ndarray) -> None:
    """``prof_lvl{1,2,3}.h5``: (N,) ids + (N, 5, 768) top-5 major vectors."""
    import h5py

    _ensure_parent(path)
    with h5py.File(path, "w") as f:
        f.create_dataset("user_id", data=np.asarray(user_ids, dtype=np.int32))
        f.create_dataset("user_major_embs",
                         data=np.asarray(user_major_embs, dtype=np.float32),
                         compression="gzip")


def read_prof_lvl(path: str):
    import h5py

    with h5py.File(path, "r") as f:
        return f["user_id"][:].astype(np.int32), f["user_major_embs"][:].astype(np.float32)


@dataclasses.dataclass
class InteractionData:
    """In-memory form of user_item_interact.h5."""

    user_ids: np.ndarray            # (U,) int32, 1-based
    user_profiles: List[str]        # (U,) strings
    item_id_lists: List[np.ndarray]  # per-user int32 sequences (time ordered)

    @property
    def num_users(self) -> int:
        return len(self.user_ids)

    @property
    def max_item_id(self) -> int:
        mx = 0
        for seq in self.item_id_lists:
            if len(seq):
                mx = max(mx, int(np.max(seq)))
        return mx


def write_interactions(path: str, data: InteractionData) -> None:
    import h5py

    _ensure_parent(path)
    with h5py.File(path, "w") as f:
        f.create_dataset("user_id", data=np.asarray(data.user_ids, dtype=np.int32))
        f.create_dataset("user_profile", data=np.array(data.user_profiles, dtype=object),
                         dtype=h5py.special_dtype(vlen=str))
        ds = f.create_dataset("item_id_list", (len(data.item_id_lists),),
                              dtype=h5py.special_dtype(vlen=np.dtype("int32")))
        for i, seq in enumerate(data.item_id_lists):
            ds[i] = np.asarray(seq, dtype=np.int32)


def read_interactions(path: str) -> InteractionData:
    import h5py

    with h5py.File(path, "r") as f:
        user_ids = f["user_id"][:].astype(np.int32)
        user_profiles = _decode(f["user_profile"][:])
        item_lists = [np.asarray(x, dtype=np.int32) for x in f["item_id_list"][:]]
    return InteractionData(user_ids, user_profiles, item_lists)


@dataclasses.dataclass
class TigerSplit:
    """One split of tiger/{train,test}_dataset.h5 (flattened offset tokens)."""

    user_ids: np.ndarray              # (N,) int32
    histories: List[np.ndarray]       # per-sample flattened int32 token seqs
    targets: List[np.ndarray]         # per-sample flattened int32 token seqs


def write_tiger_split(path: str, split: TigerSplit) -> None:
    import h5py

    vlen_int32 = h5py.special_dtype(vlen=np.dtype("int32"))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("user_id", data=np.asarray(split.user_ids, dtype=np.int32))
        h = f.create_dataset("history", (len(split.histories),), dtype=vlen_int32)
        t = f.create_dataset("target", (len(split.targets),), dtype=vlen_int32)
        for i, (hist, tgt) in enumerate(zip(split.histories, split.targets)):
            h[i] = np.asarray(hist, dtype=np.int32)
            t[i] = np.asarray(tgt, dtype=np.int32)


def read_tiger_split(path: str) -> TigerSplit:
    import h5py

    with h5py.File(path, "r") as f:
        user_ids = (f["user_id"][:].astype(np.int32) if "user_id" in f
                    else np.arange(len(f["history"]), dtype=np.int32))
        histories = [np.asarray(x, dtype=np.int32) for x in f["history"][:]]
        targets = [np.asarray(x, dtype=np.int32) for x in f["target"][:]]
    return TigerSplit(user_ids, histories, targets)


def write_course_info(path: str, item_ids: Sequence[str], item_names: Sequence[str],
                      item_infos: Sequence[str]) -> None:
    import h5py

    _ensure_parent(path)
    vlen_str = h5py.special_dtype(vlen=str)
    with h5py.File(path, "w") as f:
        f.create_dataset("item_id", data=np.array(item_ids, dtype=object), dtype=vlen_str)
        f.create_dataset("item_name", data=np.array(item_names, dtype=object), dtype=vlen_str)
        f.create_dataset("item_info", data=np.array(item_infos, dtype=object), dtype=vlen_str)


def read_course_info(path: str):
    import h5py

    with h5py.File(path, "r") as f:
        return _decode(f["item_id"][:]), _decode(f["item_name"][:]), _decode(f["item_info"][:])


def write_id_map(path: str, orig_ids: Sequence[str], num_ids: Sequence[int],
                 key_prefix: str = "item") -> None:
    """``course_id_map.h5`` / ``user_id_map.h5``: original → dense 1-based id."""
    import h5py

    _ensure_parent(path)
    with h5py.File(path, "w") as f:
        f.create_dataset(f"{key_prefix}_id", data=np.array(orig_ids, dtype=object),
                         dtype=h5py.special_dtype(vlen=str))
        f.create_dataset(f"{key_prefix}_num_id", data=np.asarray(num_ids, dtype=np.int64))


def read_id_map(path: str, key_prefix: str = "item") -> Dict[str, int]:
    import h5py

    with h5py.File(path, "r") as f:
        ids = _decode(f[f"{key_prefix}_id"][:])
        nums = f[f"{key_prefix}_num_id"][:]
    return {i: int(n) for i, n in zip(ids, nums)}


def write_recommendation_data(path: str, classes: Dict[str, np.ndarray],
                              interactions: Dict[str, np.ndarray],
                              students: Dict[str, np.ndarray]) -> None:
    """``recommendation_data.h5`` (`Baseline/data_process.py:39-105`)."""
    import h5py

    _ensure_parent(path)
    with h5py.File(path, "w") as f:
        for group_name, table in (("classes", classes), ("interactions", interactions),
                                  ("students", students)):
            g = f.create_group(group_name)
            for key, arr in table.items():
                arr = np.asarray(arr)
                if arr.dtype.kind in ("U", "O"):
                    g.create_dataset(key, data=arr.astype(object),
                                     dtype=h5py.special_dtype(vlen=str))
                else:
                    g.create_dataset(key, data=arr)


def read_recommendation_data(path: str):
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        for group_name in ("classes", "interactions", "students"):
            g = f[group_name]
            table = {}
            for key in g:
                arr = g[key][:]
                if arr.dtype.kind in ("S", "O"):
                    arr = np.array(_decode(arr), dtype=object)
                table[key] = arr
            out[group_name] = table
    return out["classes"], out["interactions"], out["students"]
