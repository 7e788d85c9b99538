"""One rank of tests/test_torch_mesh.py's gloo launch: 8 CPU processes as
a (4, 2) ``("data", "model")`` mesh (the reference's shape), W = 8 workers,
so W_local = 2 and the two-fetch roll runs.

    python tests/_torch_mesh_ranks.py RANK WORLD STORE INPUTS.npz OUT_DIR

Every rank reads the same inputs (global arrays, made by the test from a
seed and run through the reference's engines), calls the port's regions
(repro_torch.launch.mesh) on its own slices round by round, and writes
what it got to OUT_DIR/rank<RANK>.npz: its local slices, the bytes it put
on the wire beside the bytes launch/hlo_analysis.py plans for that send,
and the outcome of the mesh checks.  Imports torch and the port only.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.asgd import ASGDConfig
from repro_torch.core.gossip import GossipConfig, leaf_groups
from repro_torch.core.packing import pack_spec_w
from repro_torch.kernels.gossip_blend import (gossip_blend_w_resident,
                                              gossip_blend_worker_batched)
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import mesh as MM

W, BLOCK_ROWS, P, EPS = 8, 8, 2, 0.05
SHIFTS = (1, 2, 3, 5)          # r = 1 with one local fetch, r = 0, both
#                                fetches remote, q = 2
ELASTIC_SHIFTS = (1,)
DEAD, T0, K = 5, 2, 2          # the elastic schedule: worker 5 is down in
#                                rounds 2-3 of 7
ELASTIC_ROUNDS = 7
MESH = (4, 2)
POD_MESH = (2, 2, 2)


def tree_shapes():
    return {"a": (W, 20, 30), "b": (W, 6)}


def cases():
    """(engine, wire, delay, elastic) of every case the launch runs; the
    'packed' engine's cases drive shard_map_gossip_round, the 'pipelined'
    ones the initiate and consume regions and shard_map_pipelined_round."""
    for engine in ("packed", "pipelined"):
        for wire in (None, "int8"):
            for delay in (0, 1):
                yield engine, wire, delay, False
            yield engine, wire, 1, True


def case_id(engine, wire, delay, elastic):
    return (f"{engine}-{wire or 'f32'}-d{delay}"
            f"{'-elastic' if elastic else ''}")


def config_kw(wire, delay, elastic):
    """GossipConfig and ASGDConfig keywords of a case, shared by both
    packages' configs.  Elastic cases run the reference's schedule with
    the Parzen test off, so only liveness closes a gate."""
    return (dict(shifts=ELASTIC_SHIFTS if elastic else SHIFTS,
                 partial_blocks=P, partial_mode="leaves", delay=delay,
                 wire_format=wire, fused_block_rows=BLOCK_ROWS),
            dict(eps=EPS, use_parzen=not elastic))


def _t(a):
    return torch.from_numpy(np.array(a))


def _ints(inp, key, *names):
    return tuple(int(inp[f"{key}.{n}"]) for n in names)


class Rank:
    def __init__(self, inputs):
        self.inp = inputs
        self.out = {}
        tree = {k: torch.zeros(s) for k, s in tree_shapes().items()}
        self.spec = pack_spec_w(tree, block_rows=BLOCK_ROWS,
                                groups=leaf_groups(tree, P), n_groups=P)
        self.plain_spec = pack_spec_w(tree, block_rows=BLOCK_ROWS)

    def local(self, mesh, key):
        return MM.shard_workers(_t(self.inp[key]), mesh)

    def put(self, key, x):
        if x is not None:
            self.out[key] = x.numpy()

    def run_case(self, mesh, engine, wire, delay, elastic, prefix=""):
        """Every round of one case, each from the reference's state before
        it (the test's inputs), on this rank's slices."""
        cid = case_id(engine, wire, delay, elastic)
        gkw, akw = config_kw(wire, delay, elastic)
        gcfg, acfg = GossipConfig(**gkw), ASGDConfig(**akw)
        kw = dict(n_workers=W, elastic=elastic)
        int8 = wire == "int8"
        pdw = self.local(mesh, "pdw")
        if engine == "packed":
            regions = {"round": MM.shard_map_gossip_round(
                mesh, self.spec, gcfg, acfg, **kw)}
        else:
            regions = {
                "pipe": MM.shard_map_pipelined_round(mesh, self.spec, gcfg,
                                                     acfg, **kw),
                "init": MM.shard_map_initiate_exchange(mesh, self.spec,
                                                       gcfg, **kw),
                "cons": MM.shard_map_consume_blend(mesh, self.spec, gcfg,
                                                   acfg, **kw)}
        for t in range(int(self.inp[f"{cid}.rounds"])):
            key = f"{cid}.{t}"
            pk, ext = self.local(mesh, f"{key}.pk"), self.local(
                mesh, f"{key}.ext")
            ext_s = (self.local(mesh, f"{key}.ext_s"),) if int8 else ()
            ext_idx, step, si, bi = _ints(self.inp, key, "ext_idx", "step",
                                          "si", "bi")
            lives = ((self.local(mesh, f"{key}.ext_live"),
                      self.local(mesh, f"{key}.live")) if elastic else ())
            before = {n: r.bytes_sent for n, r in regions.items()}
            got = {}
            if engine == "packed":
                got["round"] = regions["round"](pk, pdw, ext, *ext_s,
                                                ext_idx, step, si, bi,
                                                *lives)
            else:
                got["pipe"] = regions["pipe"](pk, pdw, ext, *ext_s, ext_idx,
                                              step, si, bi, *lives)
                init = regions["init"](pk, si, bi, *lives[1:])
                got["init"] = init if isinstance(init, tuple) else (init,)
                got["cons"] = regions["cons"](pk, pdw, ext, *ext_s, ext_idx,
                                              step, *lives)
            for name, outs in got.items():
                names = {"cons": ("new", "gates"),
                         "init": ("sent",) + (("sent_s",) if int8 else ())
                         + (("sent_live",) if elastic else ())}.get(
                    name, ("new", "sent") + (("sent_s",) if int8 else ())
                    + ("gates",) + (("sent_live",) if elastic else ()))
                if len(outs) != len(names):
                    raise AssertionError(f"{name}: {len(outs)} outputs, "
                                         f"want {names}")
                for n, x in zip(names, outs):
                    self.put(f"{prefix}{key}.{name}.{n}", x)
                self.out[f"{prefix}{key}.{name}.bytes"] = np.int64(
                    regions[name].bytes_sent - before[name])
                if name != "cons":     # the regions that send
                    self.out[f"plan:{prefix}{key}.{name}"] = np.int64(
                        HA.ppermute_bytes(
                            self.spec, gcfg, MM.n_worker_groups(mesh),
                            MM.local_worker_count(mesh, W), si, bi,
                            elastic=elastic))

    def run_workers(self, mesh):
        """shard_map_workers over the worker-batched blend (B2r/B2a), the
        partition mask replicated."""
        args = [_t(self.inp[k]) for k in ("w3", "d3", "e4")]
        mask = _t(self.inp["mask"])
        out, gates = MM.shard_map_workers(
            lambda w, d, e: gossip_blend_worker_batched(w, d, e, EPS),
            mesh)(*args)
        self.put("smw.out", out)
        self.put("smw.gates", gates)
        out, gates = MM.shard_map_workers(
            lambda w, d, e, m: gossip_blend_worker_batched(w, d, e, EPS,
                                                           mask2d=m),
            mesh, replicated_argnums=(3,))(*args, mask)
        self.put("smw_mask.out", out)
        self.put("smw_mask.gates", gates)

    def run_psum(self, mesh):
        """The blends with each worker's rows split across the two 'model'
        ranks and psum_axes=("model",): B2 (masked) and B1 (f32 and int8
        externals) on this rank's rows."""
        m = dist.get_rank(mesh.get_group("model"))

        def half(rows):
            return slice(m * rows // 2, (m + 1) * rows // 2)
        cut = half(self.plain_spec.rows)
        w3, d3, e4 = (self.local(mesh, k)[..., cut, :]
                      for k in ("w3", "d3", "e4"))
        mask = _t(self.inp["mask"])[cut]
        out, gates = gossip_blend_worker_batched(
            w3, d3, e4, EPS, mask2d=mask, psum_axes=("model",), mesh=mesh)
        self.put("psum_b2.out", out)
        self.put("psum_b2.gates", gates)
        rows = self.spec.rows // 2
        cut = half(self.spec.rows)
        pk, pdw, ext = (self.local(mesh, k)[:, cut]
                        for k in ("psum.pk", "pdw", "psum.ext"))
        out, gates = gossip_blend_w_resident(
            pk, pdw, ext[:, None], (0, rows), EPS, block_rows=BLOCK_ROWS,
            psum_axes="model", mesh=mesh)
        self.put("psum_b1.out", out)
        self.put("psum_b1.gates", gates)
        q = self.local(mesh, "psum.q")[:, cut]
        nb = rows // BLOCK_ROWS
        s = self.local(mesh, "psum.s")[:, m * nb:(m + 1) * nb]
        out, gates = gossip_blend_w_resident(
            pk, pdw, q[:, None], (0, rows), EPS, ext_scales=s[:, None],
            block_rows=BLOCK_ROWS, psum_axes=("model",), mesh=mesh)
        self.put("psum_b1_int8.out", out)
        self.put("psum_b1_int8.gates", gates)

    def run_checks(self, mesh):
        """Mesh construction and the errors the module promises, as 0/1."""
        def raises(fn, exc=ValueError):
            try:
                fn()
            except exc:
                return 1
            return 0
        c = {
            "shape": np.array(mesh.shape),
            "groups": MM.n_worker_groups(mesh),
            "w_local": MM.local_worker_count(mesh, W),
            "host_clamped": np.array(MM.make_host_mesh(16, 2, "cpu").shape),
            "prod_raises": raises(lambda: MM.make_production_mesh(
                device="cpu")),
            "indivisible_raises": raises(
                lambda: MM.local_worker_count(mesh, 6)),
            # a meta tensor (the dry-run's trace) travels nowhere: the
            # gather returns the shape it would have
            "meta_gathers": int(tuple(MM.gather_workers(
                torch.zeros(2, device="meta"), mesh).shape)
                == (2 * MM.n_worker_groups(mesh),)),
            "unknown_dim_raises": raises(lambda: MM.psum_rank_order(
                torch.zeros(2), mesh, "expert")),
            "no_data_axes_raises": raises(lambda: MM.shard_map_workers(
                None, MM._auto_mesh((8,), ("model",), "cpu"))),
            "wrong_slice_raises": raises(lambda: MM.shard_map_gossip_round(
                mesh, self.spec, GossipConfig(**config_kw(None, 1, False)[0]),
                ASGDConfig(eps=EPS), n_workers=W)(
                    _t(self.inp["pdw"]), _t(self.inp["pdw"]),
                    _t(self.inp["pdw"]), 0, 1, 0, 0)),
        }
        for k, v in c.items():
            self.out[f"check.{k}"] = np.asarray(v)


def main(argv):
    rank, world, store, inputs, out_dir = argv
    rank, world = int(rank), int(world)
    MM.init_ranks(store, rank, world, device="cpu")
    try:
        r = Rank(np.load(inputs))
        mesh = MM.make_host_mesh(*MESH, device="cpu")
        for case in cases():
            r.run_case(mesh, *case)
        r.run_workers(mesh)
        r.run_psum(mesh)
        r.run_checks(mesh)
        # a ("pod", "data", "model") mesh: the worker axis is the flattened
        # (pod, data) group, pod-major — the same W_local = 2 slices
        pod = MM._auto_mesh(POD_MESH, ("pod", "data", "model"), "cpu")
        r.out["pod.groups"] = np.int64(MM.n_worker_groups(pod))
        r.run_case(pod, "packed", "int8", 1, False, prefix="pod:")
        np.savez(f"{out_dir}/rank{rank}.npz", **r.out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
