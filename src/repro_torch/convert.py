"""State carried across: a built index as plain numpy arrays.

The port's analogue of a weight converter.  ``numpy_state`` reads the
fields of any meta index and region of the reference's shape (duck-typed:
it needs the attributes, not the classes), and ``state_from_numpy``
builds the port's ``MetaIndex`` and ``Store`` from those arrays, so an
index built once — by either package — can be searched by both.

meta_arrays:  ``reps``, ``rep_ids``, ``assignments`` and ``graph`` =
              {``vectors``, ``adjacency``, ``entry``, ``n_levels``,
              ``node_level``}
store_arrays: ``spec`` = {``dim``, ``deg``, ``np_max``, ``ov_cap``,
              ``slot_vecs``, ``n_partitions``, ``quant_group``},
              ``graph_buf``, ``vec_buf``, ``meta_table``, ``n_base`` and,
              when the int8 mirror is attached, ``qvec_buf``,
              ``qscale_buf`` (None otherwise)

``lm_params_from_numpy`` does the same for an LM's parameters: the
reference's params pytree (nested dicts, leaves as numpy arrays) becomes
the port's tree of tensors in the dtypes a serving copy keeps.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hnsw import PaddedGraph
from repro_torch.core.layout import LayoutSpec, Store
from repro_torch.core.meta import MetaIndex

SPEC_FIELDS = ("dim", "deg", "np_max", "ov_cap", "slot_vecs",
               "n_partitions", "quant_group")
GRAPH_FIELDS = ("vectors", "adjacency", "entry", "n_levels", "node_level")


def numpy_state(meta, store) -> tuple[dict, dict]:
    """(meta_arrays, store_arrays) of a built index, as copies."""
    g = meta.graph
    meta_arrays = {
        "reps": np.array(meta.reps), "rep_ids": np.array(meta.rep_ids),
        "assignments": np.array(meta.assignments),
        "graph": {"vectors": np.array(g.vectors),
                  "adjacency": np.array(g.adjacency),
                  "entry": int(g.entry), "n_levels": int(g.n_levels),
                  "node_level": np.array(g.node_level)}}
    q = store.qvec_buf is not None
    store_arrays = {
        "spec": {f: int(getattr(store.spec, f)) for f in SPEC_FIELDS},
        "graph_buf": np.array(store.graph_buf),
        "vec_buf": np.array(store.vec_buf),
        "meta_table": np.array(store.meta_table),
        "n_base": np.array(store.n_base),
        "qvec_buf": np.array(store.qvec_buf) if q else None,
        "qscale_buf": np.array(store.qscale_buf) if q else None}
    return meta_arrays, store_arrays


def state_from_numpy(meta_arrays: dict,
                     store_arrays: dict) -> tuple[MetaIndex, Store]:
    """The port's (MetaIndex, Store) from the arrays ``numpy_state``
    describes, with the reference's dtypes."""
    g = meta_arrays["graph"]
    graph = PaddedGraph(
        vectors=np.asarray(g["vectors"], np.float32),
        adjacency=np.asarray(g["adjacency"], np.int32),
        entry=int(g["entry"]), n_levels=int(g["n_levels"]),
        node_level=np.asarray(g["node_level"], np.int32))
    meta = MetaIndex(reps=np.asarray(meta_arrays["reps"], np.float32),
                     rep_ids=np.asarray(meta_arrays["rep_ids"]),
                     graph=graph,
                     assignments=np.asarray(meta_arrays["assignments"],
                                            np.int32))
    spec = LayoutSpec(**{f: int(store_arrays["spec"][f])
                         for f in SPEC_FIELDS})
    qv, qs = store_arrays.get("qvec_buf"), store_arrays.get("qscale_buf")
    store = Store(spec=spec,
                  graph_buf=np.asarray(store_arrays["graph_buf"], np.int32),
                  vec_buf=np.asarray(store_arrays["vec_buf"], np.float32),
                  meta_table=np.asarray(store_arrays["meta_table"], np.int32),
                  n_base=np.asarray(store_arrays["n_base"], np.int32),
                  qvec_buf=None if qv is None else np.asarray(qv, np.int8),
                  qscale_buf=None if qs is None else np.asarray(qs,
                                                                np.float32))
    return meta, store


def lm_params_from_numpy(cfg, tree: dict, device) -> dict:
    """The port's LM params from the reference's params tree as numpy
    arrays (same nesting and leaf names; ``device`` "cuda" or "cpu").
    Each leaf is kept in ``models.model.stored_dtype``: the matrices in
    ``cfg.dtype``, the embedding table and norm scales in f32."""
    from repro_torch.models.model import stored_dtype

    def conv(node):
        return {key: conv(val) if isinstance(val, dict) else
                torch.as_tensor(np.array(val, np.float32), device=device)
                .to(stored_dtype(cfg, key))
                for key, val in node.items()}
    return conv(tree)
