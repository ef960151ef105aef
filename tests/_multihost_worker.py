"""Worker process for the 2-process multi-host integration test.

Launched by tests/test_parallel.py::test_multihost_two_process_dp — one
OS process per "host", jax.distributed over localhost (the DCN path at
process granularity), CPU backend, cross-process collectives via gloo.
Each process holds half the global batch of a dp=2-sharded ConvOp
forward and asserts its shard is bit-identical to the unsharded op.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from deepfusion_tpu.utils import env  # noqa: E402

env.set_interpret_kernels(True)             # kernels on the CPU backend

import numpy as np  # noqa: E402


def main():
    port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    from deepfusion_tpu.parallel import distributed
    distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, "distributed runtime not up"
    assert jax.device_count() == nproc * jax.local_device_count()

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from deepfusion_tpu.config import ConvConfig
    from deepfusion_tpu.ops.conv import ConvOp
    from deepfusion_tpu.parallel.shard import dp_shard

    rng = np.random.default_rng(7)
    bs, hw, ic, oc = 4, 9, 32, 32
    src = rng.integers(0, 256, (bs, hw, hw, ic), dtype=np.uint8)
    wei = rng.integers(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
    bia = rng.integers(-100, 101, (oc,)).astype(np.int32)
    cfg = ConvConfig.make((bs, hw, hw, ic), (oc, ic, 3, 3), bia.dtype,
                          (1, 1), (1, 1), (bs, hw, hw, oc), "u8",
                          conv0_scales=(0.02,))
    op = ConvOp(cfg, wei, bia)

    mesh = Mesh(np.array(jax.devices()).reshape(-1), ("dp",))
    fn = dp_shard(op, mesh)
    sharding = NamedSharding(mesh, P("dp", None, None, None))
    # every process feeds only its LOCAL rows of the global batch — the
    # multi-host input path (host 0 never sees host 1's data)
    n_shard = mesh.shape["dp"]
    rows = bs // n_shard
    locals_ = np.concatenate(
        [src[d.process_index * (bs // nproc):][:rows][None]
         for d in mesh.devices.flat if d.process_index == pid])
    # simple equal split: device i gets rows [i*rows, (i+1)*rows)
    gx = jax.make_array_from_process_local_data(
        sharding, src[pid * (bs // nproc):(pid + 1) * (bs // nproc)])
    del locals_
    out = fn(gx)

    # reference: the unsharded op on this process (full batch, local)
    want = np.asarray(op(src))
    for s in out.addressable_shards:
        lo = s.index[0].start or 0
        got = np.asarray(s.data)
        np.testing.assert_array_equal(got, want[lo:lo + got.shape[0]])
    # --- sp_packed across processes: the packed-domain ppermute halo
    # exchange rides the CROSS-PROCESS collective path (each process
    # owns one horizontal slab of the image; its halo rows arrive from
    # the neighbor process)
    from jax.sharding import NamedSharding as NS
    from deepfusion_tpu.ops.packed import (PackedConvOp, pack_image,
                                           pack_image_sharded,
                                           unpack_image)
    from deepfusion_tpu.parallel.shard import sp_packed

    rng2 = np.random.default_rng(11)
    hw2 = 16
    src2 = rng2.integers(0, 256, (2, hw2, hw2, 32), dtype=np.uint8)
    wei2 = rng2.integers(-10, 11, (32, 32, 3, 3)).astype(np.int8)
    cfg2 = ConvConfig.make((2, hw2, hw2, 32), (32, 32, 3, 3), None,
                           (1, 1), (1, 1), (2, hw2, hw2, 32), "u8",
                           conv0_relu=True, conv0_scales=(0.05,))
    op2 = PackedConvOp(cfg2, wei2)
    n_sp = jax.device_count()
    mesh2 = Mesh(np.array(jax.devices()).reshape(-1), ("sp",))
    fn2 = sp_packed(op2, mesh2)
    xs = pack_image_sharded(src2, fn2.local_spec, n_sp)
    rl_in = fn2.local_spec.rows * fn2.local_spec.iwp
    sh2 = NS(mesh2, P(None, "sp", None))
    per_proc = n_sp // nproc
    gx2 = jax.make_array_from_process_local_data(
        sh2, xs[:, pid * per_proc * rl_in:(pid + 1) * per_proc * rl_in])
    out2 = fn2(gx2)
    want2 = unpack_image(
        np.asarray(op2(pack_image(src2, op2.sin))), op2.sout)
    h_loc = hw2 // n_sp
    so_l = fn2.local_out_spec
    for s in out2.addressable_shards:
        lo = (s.index[1].start or 0) // (so_l.rows * so_l.iwp)
        got = unpack_image(np.asarray(s.data), so_l)
        np.testing.assert_array_equal(
            got, want2[:, lo * h_loc:(lo + 1) * h_loc])
    print(f"MULTIHOST_SP_OK {pid}", flush=True)

    print(f"MULTIHOST_OK {pid} procs={jax.process_count()} "
          f"devices={jax.device_count()}", flush=True)


if __name__ == "__main__":
    main()
