"""Dry-run of the port over the production meshes: trace every (arch x
shape x mesh) cell as one rank, on fake tensors, and price it with an
NVIDIA H100's roofline (``launch/mesh.py``).  The port of ``repro``'s
``launch/dryrun.py``, which lowers each cell through GSPMD and reads
XLA's cost and memory analyses; PyTorch has no GSPMD, so here:

- the mesh is a ``DeviceMesh`` over a *fake* process group
  (:func:`mesh.make_dryrun_mesh`), this process being rank 0;
- each argument is rank 0's shard, a fake tensor of the shard's shape
  wrapped as a ``DTensor`` with the cell's placements
  (``DTensor.from_local``), and ``fn`` runs on them under
  ``implicit_replication()`` (plain tensors made inside the model stand
  as replicated), so DTensor chooses the collectives that the layouts
  call for;
- :class:`Trace`, a ``FakeTensorMode`` that counts, sees every op on
  rank 0's *local* tensors (below DTensor's dispatch; the ops DTensor
  runs on global shapes to propagate metadata are not counted) and
  records:

  - ``flops_per_chip``: ``torch.utils.flop_counter``'s formulas of each
    local op (the custom ops register theirs);
  - ``bytes_per_chip``: each local op reads its inputs once and writes its
    outputs once, with no fusion (views, allocations and collectives move
    nothing).  XLA counts after fusion, so this is larger and
    ``t_memory_s`` pessimistic;
  - ``collectives``: the bytes of each collective by kind, the reference's
    convention: all-gather its gathered output, reduce-scatter its
    scattered output, all-reduce and all-to-all their output; both the
    ``c10d`` ops (the ripple path's ``torch.distributed`` calls) and the
    ``_c10d_functional`` ones (DTensor's redistributes).  Each is priced at
    the rate of its group's span (NVLink within a node, the network
    across);
  - ``mem_per_device``: ``argument_bytes`` (the local arguments),
    ``output_bytes`` (outputs that are not arguments updated in place),
    ``peak_bytes`` (the most bytes of live storage during the trace,
    arguments included: a storage counts from the op that made it until
    its last tensor dies) and ``temp_bytes = peak - argument - output``.

Nothing is allocated on any device.  Layers are a Python loop, so a trace
at full depth counts every layer (no probes).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --mesh single --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._pytree import tree_flatten as _pytree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.common import (SDS, local_shape, placements,
                                        sanitize_spec, tree_map_specs)
from repro_torch.launch import dtensor_rules
from repro_torch.launch.mesh import (HBM_BW, NET_BW, NVLINK_BW, PEAK_FLOPS,
                                     group_bandwidth, make_dryrun_mesh)
from repro_torch.utils import human_bytes, human_count

CARD = "NVIDIA H100 80GB HBM3, 700 W"
MESHES = {"single": ("pod16x16", (16, 16), ("data", "model")),
          "multi": ("2pod 2x16x16", (2, 16, 16), ("pod", "data", "model"))}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# collective op name -> (kind, index of the argument whose bytes count:
# "out" the op's result)
_COLL_OPS = {
    # torch.distributed's c10d ops (a process group argument)
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_base_": ("all-to-all", 0),
    "alltoall_": ("all-to-all", 0),
    "broadcast_": ("all-gather", 0),
    "send": ("collective-permute", 0),
    # the functional ones (a group name argument); DTensor's
    "all_reduce": ("all-reduce", "out"),
    "all_reduce_coalesced": ("all-reduce", "out"),
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "out"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "out"),
    "all_to_all_single": ("all-to-all", "out"),
    "broadcast": ("all-gather", "out"),
}
_COLL_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
# ops that move no data: allocations without a write, metadata
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "device", "detach", "alias", "lift_fresh",
         "wait_tensor", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "_local_scalar_dense", "set_"}


def _tensors(tree) -> list:
    return [t for t in _pytree_leaves(tree)[0] if isinstance(t, torch.Tensor)]


def _ranks_of(arg) -> list | None:
    """The global ranks of a collective's group argument: a group name
    (functional collectives) or a ``ProcessGroup`` script object."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    try:
        if isinstance(arg, str):
            pg = c10d._resolve_process_group(arg)
        elif isinstance(arg, torch.ScriptObject):
            pg = dist.ProcessGroup.unbox(arg)
        elif isinstance(arg, dist.ProcessGroup):
            pg = arg
        else:
            return None
    except Exception:   # not a group
        return None
    return dist.get_process_group_ranks(pg)


class Trace(FakeTensorMode):
    """A ``FakeTensorMode`` that counts rank 0's work: FLOPs, bytes moved,
    collective bytes by kind and the live storage's peak (see the module
    docstring).  Counting is on inside :meth:`counting`; ops on real
    tensors only (a ``DeviceMesh``'s own rank bookkeeping) are never
    counted."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self._depth = 0
        self._counting = False
        self.reset()
        # storage id -> [nbytes, live tensor count, weak ref]
        self._live: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def reset(self) -> None:
        self.flops = 0
        self.bytes = 0
        self.coll = dict.fromkeys(_COLLECTIVES, 0.0)
        self.coll_s = 0.0
        self.ops = 0

    @contextlib.contextmanager
    def counting(self):
        self.reset()
        self.peak_bytes = self.live_bytes
        self._counting = True
        try:
            yield self
        finally:
            self._counting = False

    # -- live storage ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        if getattr(t, "_dryrun_seen", False):
            return
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        key = ref.cdata
        slot = self._live.get(key)
        if slot is None:
            slot = self._live[key] = [st.nbytes(), 0, ref]
            self.live_bytes += slot[0]
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
        slot[1] += 1
        t._dryrun_seen = True
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        slot = self._live.get(key)
        if slot is None:
            return
        slot[1] -= 1
        if slot[1] == 0:
            self.live_bytes -= slot[0]
            del self._live[key]

    def storage_bytes(self, tensors) -> int:
        """Bytes of the distinct storages under ``tensors``."""
        seen = {}
        for t in tensors:
            st = t.untyped_storage()
            seen[StorageWeakRef(st).cdata] = st.nbytes()
        return sum(seen.values())

    # -- dispatch -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        mine = not ins or any(isinstance(t, FakeTensor) for t in ins)
        top = self._depth == 0
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is NotImplemented or not mine:
            return out
        outs = _tensors(out)
        # storage is tracked at every depth: an op that fake mode runs as
        # a decomposition holds its temporaries while it runs, as the
        # card's composite kernels do; work is counted once, at the top
        for t in outs:
            self._track(t)
        if top and self._counting:
            self._count(func, args, kwargs, out, outs)
        return out

    def _count(self, func, args, kwargs, out, outs) -> None:
        self.ops += 1
        name = func._schema.name.split("::")[-1]
        if func.namespace in _COLL_NAMESPACES:
            self._count_collective(name, args, kwargs, outs)
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if name in _FREE or name.startswith("empty"):
            return
        ins = _tensors((args, kwargs))
        if not func._schema.is_mutable:
            in_ids = {StorageWeakRef(t.untyped_storage()).cdata for t in ins}
            if outs and all(StorageWeakRef(o.untyped_storage()).cdata
                            in in_ids for o in outs):
                return            # a view: no data moves
        self.bytes += sum(t.nbytes for t in ins) + sum(o.nbytes for o in outs)

    def _count_collective(self, name, args, kwargs, outs) -> None:
        entry = _COLL_OPS.get(name)
        if entry is None:
            if name in ("wait_tensor", "barrier", "monitored_barrier_"):
                return
            raise NotImplementedError(f"collective {name!r} has no byte "
                                      f"rule in the dry-run")
        kind, which = entry
        moved = outs if which == "out" else _tensors(args[which])
        nbytes = sum(t.nbytes for t in moved)
        ranks = None
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, (str, torch.ScriptObject)) or \
                    type(a).__name__ == "ProcessGroup":
                ranks = _ranks_of(a)
                if ranks is not None:
                    break
        if ranks is None:
            raise RuntimeError(f"collective {name!r}: no process group "
                               f"among its arguments")
        self.coll[kind] += nbytes
        if len(ranks) > 1:
            self.coll_s += nbytes / group_bandwidth(ranks)


@contextlib.contextmanager
def _propagation_outside():
    """DTensor's sharding propagation runs outside the trace's fake mode:
    it propagates an op's output metadata by running the op on fake
    tensors of the *global* shapes (under a fake mode of its own once
    ours is unset; that is not rank 0's work) and computes shard offsets
    with real tensor ops.  The propagator is patched on its instance
    (its cache holds bound methods) and restored after."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    names = [n for n in ("propagate_op_sharding",
                         "propagate_op_sharding_non_cached")
             if hasattr(prop, n)]
    if not names:
        raise RuntimeError(f"torch {torch.__version__}: DTensor's sharding "
                           f"propagator has no propagate_op_sharding")
    saved = {n: prop.__dict__.get(n) for n in names}

    def outside(orig):
        def wrapped(*a, **k):
            with unset_fake_temporarily():
                return orig(*a, **k)
        return wrapped

    for n in names:
        setattr(prop, n, outside(getattr(prop, n)))
    # a strided shard's offsets come from index arithmetic on tensors
    from torch.distributed.tensor import placement_types as pt
    strided = getattr(pt, "_StridedShard", None)
    raw = strided.__dict__.get("local_shard_size_and_offset") \
        if strided is not None else None
    if raw is not None:
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw
        setattr(strided, "local_shard_size_and_offset",
                staticmethod(outside(fn)) if isinstance(raw, staticmethod)
                else outside(fn))
    try:
        yield
    finally:
        for n, orig in saved.items():
            if orig is None:
                delattr(prop, n)
            else:
                setattr(prop, n, orig)
        if raw is not None:
            setattr(strided, "local_shard_size_and_offset", raw)


def _contiguous(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def materialize(mesh, args, specs, device):
    """Rank 0's fake arguments: each :class:`SDS` leaf of ``args`` made as
    its shard under its sanitized spec and wrapped as a ``DTensor``
    (``specs`` None: the leaves are local shapes, made plain).  Other
    leaves pass through."""
    from torch.distributed.tensor import DTensor

    def make(spec, a):
        if not isinstance(a, SDS):
            return a
        if specs is None:
            return torch.empty(a.shape, dtype=a.dtype, device=device)
        spec = sanitize_spec(mesh, spec, a.shape)
        local = torch.empty(local_shape(mesh, spec, a.shape), dtype=a.dtype,
                            device=device)
        return DTensor.from_local(local, mesh,
                                  placements(mesh, spec, len(a.shape)),
                                  run_check=False, shape=torch.Size(a.shape),
                                  stride=_contiguous(a.shape))

    if specs is None:
        return tuple(_map_leaves(lambda x: make(None, x), a) for a in args)
    return tuple(tree_map_specs(make, s, a) for s, a in zip(specs, args))


def _map_leaves(fn, tree):
    if isinstance(tree, SDS):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_map_leaves(fn, v) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    return fn(tree)


def argument_bytes(built, mesh) -> int:
    """Rank 0's argument bytes of ``built`` from its stand-ins and specs
    alone (no trace): each leaf's shard under its sanitized spec.  A trace
    reports the same (``mem_per_device["argument_bytes"]``)."""
    total = []

    def add(spec, a):
        if isinstance(a, SDS):
            shape = a.shape if built.in_shardings is None else local_shape(
                mesh, sanitize_spec(mesh, spec, a.shape), a.shape)
            n = 1
            for d in shape:
                n *= d
            total.append(n * a.dtype.itemsize)
        return a

    if built.in_shardings is None:
        for a in built.args:
            _map_leaves(lambda x: add(None, x), a)
    else:
        for s, a in zip(built.in_shardings, built.args):
            tree_map_specs(add, s, a)
    return sum(total)


def _locals(tree) -> list:
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


def trace_cell(built, mesh, device) -> dict:
    """Trace ``built`` as rank 0 of ``mesh``; returns the raw counts."""
    from torch.distributed.tensor.experimental import implicit_replication
    dtensor_rules.register()
    trace = Trace()
    with trace, _propagation_outside():
        args = materialize(mesh, built.args, built.in_shardings, device)
        arg_locals = _locals(args)
        arg_bytes = trace.storage_bytes(arg_locals)
        arg_ids = {StorageWeakRef(t.untyped_storage()).cdata
                   for t in arg_locals}
        before = trace.live_bytes
        with trace.counting(), implicit_replication():
            out = built.fn(*args)
        out_locals = [t for t in _locals(out)
                      if StorageWeakRef(t.untyped_storage()).cdata
                      not in arg_ids]
        out_bytes = trace.storage_bytes(out_locals)
        peak = trace.peak_bytes - before + arg_bytes
        res = dict(flops=float(trace.flops), bytes=float(trace.bytes),
                   coll=dict(trace.coll), coll_s=trace.coll_s, ops=trace.ops,
                   argument_bytes=arg_bytes, output_bytes=out_bytes,
                   peak_bytes=peak,
                   temp_bytes=peak - arg_bytes - out_bytes)
        del out, args, arg_locals, out_locals
    return res


def run_cell(cell, mesh, mesh_label: str, chips: int,
             device: str = "cuda") -> dict:
    """One cell on one mesh: the reference's record, its numbers of rank 0
    (see the module docstring), priced with ``launch/mesh.py``'s H100
    constants."""
    t0 = time.time()
    built = cell.build(mesh)
    c = trace_cell(built, mesh, device)
    flops, bytes_acc = c["flops"], c["bytes"]
    coll_total = sum(c["coll"].values())
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_acc / HBM_BW
    t_coll = c["coll_s"]
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    model_flops_per_chip = built.model_flops / chips
    notes = (f"{built.notes + '; ' if built.notes else ''}traced as rank 0 "
             f"on fake tensors; priced for one {CARD}: "
             f"{PEAK_FLOPS:.4g} FLOP/s, HBM {HBM_BW:.4g} B/s, NVLink "
             f"{NVLINK_BW:.4g} B/s, network {NET_BW:.4g} B/s")
    return {
        "cell": cell.name, "kind": cell.kind, "mesh": mesh_label,
        "chips": chips,
        "compile_s": round(time.time() - t0, 1),
        "flops_per_chip": flops,
        "bytes_per_chip": bytes_acc,
        "collective_bytes_per_chip": coll_total,
        "collectives": c["coll"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": built.model_flops,
        "useful_compute_frac": (model_flops_per_chip / flops) if flops
        else 0.0,
        "mem_per_device": {
            "argument_bytes": c["argument_bytes"],
            "output_bytes": c["output_bytes"],
            "temp_bytes": c["temp_bytes"],
            "peak_bytes": c["peak_bytes"],
        },
        "notes": notes,
    }


def main(argv=None) -> int:
    from repro_torch.configs.registry import ARCHS, get_arch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all' (every arch but ripple-papers: "
                         "the assigned 40 cells and the optimised "
                         "variants) or 'extra' (ripple-papers)")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of the fake tensors and of the mesh "
                         "(DTensor picks its collectives by it)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but no CUDA device is "
                           "available; pass --device cpu to trace on the CPU")

    if args.arch == "all":
        names = [a for a in ARCHS if a != "ripple-papers"]
    elif args.arch == "extra":
        names = ["ripple-papers"]
    else:
        names = [args.arch]
    meshes = [MESHES[m] for m in ("single", "multi")
              if args.mesh in (m, "both")]

    cells = [c for name in names for c in get_arch(name).CELLS
             if not args.shape or c.shape == args.shape]
    failures = 0
    for label, shape, axes in meshes:
        mesh = make_dryrun_mesh(shape, axes, args.device)
        chips = math.prod(shape)
        for cell in cells:
            try:
                rec = run_cell(cell, mesh, label, chips, args.device)
            except Exception as e:   # noqa: BLE001 -- reported, exit 1
                failures += 1
                print(f"[FAIL] {cell.name} {label}: {e}", flush=True)
                traceback.print_exc()
                continue
            print(f"[OK] {cell.name:40s} {label:12s} "
                  f"flops/chip={human_count(rec['flops_per_chip'])} "
                  f"bytes/chip={human_bytes(rec['bytes_per_chip'])} "
                  f"coll/chip="
                  f"{human_bytes(rec['collective_bytes_per_chip'])} "
                  f"peakmem="
                  f"{human_bytes(rec['mem_per_device']['peak_bytes'])} "
                  f"dom={rec['dominant']} "
                  f"compile={rec['compile_s']}s", flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
