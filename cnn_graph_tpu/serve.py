"""Serving: one call from a trained model to a deployable artifact.

The reference has no serving layer at all — models live inside a
``tf.Session`` and die with the process (lib/graph_model.py:124-197
keeps ``self.sess`` alive just so ``predict`` can run later).  This
module is the serving story on top of the int8 path:

* :func:`compile_serving` — in-process AOT: quantize the model's graph
  operators, lower + compile the inference function ONCE for a fixed
  input shape, and return a handle whose calls skip retracing and
  recompilation entirely.
* :func:`export_serving` / :func:`load_serving` — cross-process: the
  quantized inference function is exported (``jax.export``) and written
  as its StableHLO bytecode, its calling convention (JSON) and the
  parameter/operator leaves; it loads in a process with NO model code —
  the artifact directory is the deployable unit.  The artifact is
  written without ``Exported.serialize`` (which needs the optional
  ``flatbuffers`` package), so it is rebuilt only under the JAX version
  that wrote it.

Graph operators and parameters ride as ARGUMENTS of the exported
function (flattened leaves), never closures — the same invariant as
training (DESIGN.md §9): constants embedded in the module would inflate
the artifact and its compile.  The pytree structure is captured at
export time inside the traced function, so the artifact's calling
convention is ``(list_of_arrays, x)`` — plain pytrees that serialize
without custom-node registration.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from cnn_graph_tpu.models import common

__all__ = [
    "CompiledServing",
    "LoadedServing",
    "compile_serving",
    "export_serving",
    "load_serving",
]

_ARTIFACT = "model.stablehlo"
_LEAVES = "leaves.npz"
_META = "meta.json"
_TRITON_CALL = "__gpu$xla.gpu.triton"  # custom-call target of Pallas Triton


def _model_operators(model):
    """Flat list of the model's graph operators (``op`` / ``operators``)."""
    ops = []
    for f in ("op", "operators"):
        v = getattr(model, f, None)
        if v is None:
            continue
        ops.extend(v if isinstance(v, list) else [v])
    return ops


def _prepare(model, params, example_x, int8, sample_x, headroom):
    """Quantize (optionally), split the model into (flat leaves, traced
    apply-on-leaves fn, input spec).  Returns the number of operators
    actually converted to an int8 twin (0 when the model's formats have
    no quantized counterpart — dense/BCOO stacks pass through)."""
    if sample_x is None:
        sample_x = (float(np.max(np.abs(np.asarray(example_x))))
                    if hasattr(example_x, "shape") else 1.0) or 1.0
    qmodel = (common.quantize_model_operators(model, sample_x=sample_x,
                                              headroom=headroom)
              if int8 else model)
    n_quant = sum(
        1
        for before, after in zip(_model_operators(model),
                                 _model_operators(qmodel))
        if after is not before
    )
    gtree = common.graph_arrays(qmodel)
    leaves, treedef = jax.tree_util.tree_flatten((gtree, params))

    def flat_apply(leaves, x):
        g, p = jax.tree_util.tree_unflatten(treedef, leaves)
        return common.with_graph_arrays(qmodel, g).apply(p, x)

    x_spec = jax.ShapeDtypeStruct(example_x.shape,
                                  jnp.asarray(example_x).dtype)
    return flat_apply, [jnp.asarray(v) for v in leaves], x_spec, n_quant


class CompiledServing:
    """AOT-compiled inference handle for ONE input shape.

    ``serving(x)`` runs the compiled executable directly — no tracing,
    no compile-cache lookup on the hot path.  ``input_spec`` documents
    the only accepted shape/dtype."""

    def __init__(self, compiled, leaves, x_spec):
        self._compiled = compiled
        self._leaves = leaves
        self.input_spec = x_spec

    def __call__(self, x):
        return self._compiled(self._leaves, x)

    @property
    def cost_analysis(self):
        return self._compiled.cost_analysis()


def compile_serving(model, params, example_x, int8: bool = True,
                    sample_x: float | None = None,
                    headroom: float = 2.0) -> CompiledServing:
    """Quantize + AOT-compile ``model.apply`` for ``example_x``'s shape.

    ``int8=True`` swaps every banded/halo operator for its quantized
    twin (``quantize_model_operators``); ``sample_x`` defaults to
    ``max|example_x|`` (seeds the operators' static activation scale —
    the recurrence itself re-scales at runtime inside ``cheby_conv``).
    """
    flat_apply, leaves, x_spec, _ = _prepare(
        model, params, example_x, int8, sample_x, headroom
    )
    compiled = jax.jit(flat_apply).lower(leaves, x_spec).compile()
    return CompiledServing(compiled, leaves, x_spec)


def export_serving(model, params, example_x, path: str,
                   int8: bool = True, sample_x: float | None = None,
                   headroom: float = 2.0, platforms=None) -> str:
    """Serialize the (quantized) inference function + its leaves to a
    directory loadable by :func:`load_serving` WITHOUT model code.

    ``platforms`` pins the target platform list (e.g. ``["cuda"]``);
    default is the exporting process's backend.  The artifact records
    the JAX version and loads only under the same one (on the GPU it
    also embeds the Pallas Triton kernel, whose IR JAX does not keep
    stable across versions).  Sharded (halo)
    operators are not exportable — the artifact is the single-chip
    serving unit (shard at the serving layer by graph partition
    instead).  Returns ``path``.
    """
    from jax import export as jexport

    sharded = [type(o).__name__ for o in _model_operators(model)
               if getattr(o, "mesh", None) is not None]
    if sharded:
        raise ValueError(
            f"model carries sharded (halo) operators {sharded}: the "
            "export artifact is the single-chip serving unit — a "
            "shard_map program would bake the exporting mesh's device "
            "count into the artifact.  Shard at the serving layer by "
            "graph partition instead, or rebuild the model with "
            "single-chip operators before exporting."
        )
    flat_apply, leaves, x_spec, n_quant = _prepare(
        model, params, example_x, int8, sample_x, headroom
    )
    leaf_specs = [jax.ShapeDtypeStruct(v.shape, v.dtype) for v in leaves]
    kwargs = {"platforms": platforms} if platforms else {}
    exp = jexport.export(
        jax.jit(flat_apply), disabled_checks=[
            jexport.DisabledSafetyCheck.custom_call(_TRITON_CALL)],
        **kwargs,
    )(leaf_specs, x_spec)
    if (exp.nr_devices != 1 or exp.ordered_effects or exp.unordered_effects
            or exp.uses_global_constants or len(exp.out_avals) != 1):
        raise ValueError("the serving artifact holds one single-device, "
                         "effect-free program with one output")

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _ARTIFACT), "wb") as f:
        f.write(exp.mlir_module_serialized)
    host = [np.ascontiguousarray(jax.device_get(v)) for v in leaves]
    # bf16 (ml_dtypes) doesn't round-trip through npz: store raw bytes +
    # dtype/shape metadata and rebuild with jnp.dtype at load.
    np.savez(
        os.path.join(path, _LEAVES),
        # atleast_1d: numpy forbids dtype-size-changing views of 0-d
        # arrays; shape metadata restores the original shape at load.
        **{f"a{i}": np.atleast_1d(v).view(np.uint8).reshape(-1)
           for i, v in enumerate(host)},
    )
    meta = {
        "n_leaves": len(host),
        "leaf_dtypes": [str(v.dtype) for v in host],
        "leaf_shapes": [list(v.shape) for v in host],
        "input_shape": list(x_spec.shape),
        "input_dtype": str(x_spec.dtype),
        # ``int8`` records what the artifact actually computes in: False
        # when the request converted no operator (e.g. an all-dense
        # stack), so the metadata never overstates the quantization.
        "int8": bool(int8) and n_quant > 0,
        "int8_requested": bool(int8),
        "quantized_operators": n_quant,
        "platforms": list(exp.platforms),
        "model": type(model).__name__,
        "triton_kernels": _TRITON_CALL in exp.mlir_module(),
        "jax_version": jax.__version__,
        "exported": {
            "fun_name": exp.fun_name,
            "output": [list(exp.out_avals[0].shape),
                       str(exp.out_avals[0].dtype)],
            "calling_convention_version": exp.calling_convention_version,
            "module_kept_var_idx": list(exp.module_kept_var_idx),
        },
    }
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return path


class LoadedServing:
    """Inference handle over a deserialized artifact (no model code)."""

    def __init__(self, exp, leaves, meta):
        self._fn = jax.jit(exp.call)
        self._leaves = leaves
        self.meta = meta
        self.input_spec = jax.ShapeDtypeStruct(
            tuple(meta["input_shape"]), jnp.dtype(meta["input_dtype"])
        )

    def __call__(self, x):
        return self._fn(self._leaves, x)


def _rebuild_exported(meta: dict, module: bytes):
    """The ``jax.export.Exported`` of an artifact: a stand-in with the
    artifact's signature, exported through the public API, carrying the
    artifact's StableHLO module and kept-argument list.  The stand-in's
    VJP raises, so differentiating a loaded artifact fails loudly."""
    import dataclasses

    from jax import export as jexport

    e = meta["exported"]
    out_shape, out_dtype = e["output"]
    leaf_specs = [jax.ShapeDtypeStruct(tuple(s), jnp.dtype(d))
                  for s, d in zip(meta["leaf_shapes"], meta["leaf_dtypes"])]
    x_spec = jax.ShapeDtypeStruct(tuple(meta["input_shape"]),
                                  jnp.dtype(meta["input_dtype"]))

    @jax.custom_vjp
    def stand_in(leaves, x):
        return jnp.zeros(out_shape, out_dtype)

    def no_vjp(*_):
        raise TypeError("a loaded serving artifact is inference-only")

    stand_in.defvjp(lambda leaves, x: (stand_in(leaves, x), None), no_vjp)
    stub = jexport.export(
        jax.jit(stand_in), platforms=meta["platforms"], disabled_checks=[
            jexport.DisabledSafetyCheck.custom_call(_TRITON_CALL)],
    )(leaf_specs, x_spec)
    if stub.calling_convention_version != e["calling_convention_version"]:
        raise ValueError("artifact calling convention "
                         f"{e['calling_convention_version']} differs from "
                         f"{stub.calling_convention_version} — re-export it")
    return dataclasses.replace(
        stub, fun_name=e["fun_name"], mlir_module_serialized=module,
        module_kept_var_idx=tuple(e["module_kept_var_idx"]))


def load_serving(path: str) -> LoadedServing:
    """Load an :func:`export_serving` artifact directory."""
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    if "exported" not in meta:
        raise ValueError(
            "artifact in the older format (Exported.serialize, which needs "
            "the flatbuffers package); re-export it with export_serving")
    if meta["jax_version"] != jax.__version__:
        raise ValueError(
            f"artifact written under JAX {meta['jax_version']}; this "
            f"process runs {jax.__version__} — re-export it"
        )
    with open(os.path.join(path, _ARTIFACT), "rb") as f:
        exp = _rebuild_exported(meta, f.read())
    raw = np.load(os.path.join(path, _LEAVES))
    leaves = []
    for i in range(meta["n_leaves"]):
        dt = jnp.dtype(meta["leaf_dtypes"][i])
        buf = raw[f"a{i}"].tobytes()
        leaves.append(jnp.asarray(
            np.frombuffer(buf, dt).reshape(meta["leaf_shapes"][i])
        ))
    return LoadedServing(exp, leaves, meta)
