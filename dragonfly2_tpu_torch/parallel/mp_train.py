"""One process of an N-process sharded GNN training job.

The port of dragonfly2_tpu/parallel/mp_train.py. Launched per process by
``distributed.launch_localhost`` (tests, dry runs) or by a real launcher:
joins the process group from DF_DIST_* alone (gloo on the CPU, NCCL on the
card), builds the ("data", "model") mesh over every rank, and runs
DF_MP_STEPS (12) training steps over a DF_MP_NODES (128) node cluster,
each rank feeding only its own batch rows (``distributed.local_row_slice``
+ ``process_local_batch``) from the same rng seed. Rank 0 prints
``mp_train ok: ...`` and the loss trajectory as ``MP_LOSSES <json>``. The
group is destroyed at exit.

    DF_DIST_COORDINATOR=127.0.0.1:29500 DF_DIST_NUM_PROCESSES=2 \\
    DF_DIST_PROCESS_ID=0 DF_DIST_LOCAL_DEVICES=1 \\
    python -m dragonfly2_tpu_torch.parallel.mp_train
"""

from __future__ import annotations

import json
import os


def main() -> None:
    import numpy as np
    import torch.distributed as dist

    from dragonfly2_tpu_torch.parallel import distributed as dist_lib
    from dragonfly2_tpu_torch.parallel import mesh as meshlib
    from dragonfly2_tpu_torch.trainer import synthetic, train_gnn

    cfg = dist_lib.DistributedConfig.from_env()
    dev = dist_lib.initialize(cfg)
    try:
        steps = int(os.environ.get("DF_MP_STEPS", "12"))
        num_nodes = int(os.environ.get("DF_MP_NODES", "128"))
        mesh = meshlib.make_mesh()  # every rank's device → one global mesh
        dp, tp = meshlib.axis_sizes(mesh)
        cluster = synthetic.make_cluster(num_nodes=num_nodes, num_neighbors=8, num_pairs=4096, seed=3)
        tcfg = train_gnn.GNNTrainConfig(
            hidden=32, embed_dim=16, num_layers=2,
            batch_size=meshlib.pad_to_multiple(256, dp), warmup_steps=2,
        )
        state = train_gnn.init_state(tcfg, cluster.graph, rng_seed=0, device=dev)
        state, g, step_fn = train_gnn.shard_for_training(state, cluster.graph, mesh)

        lo, hi = dist_lib.local_row_slice(tcfg.batch_size, mesh)
        rng = np.random.default_rng(0)  # same seed everywhere → same global batch
        losses = []
        for _ in range(steps):
            b = synthetic.sample_batch(cluster.pairs, tcfg.batch_size, rng)
            gb = synthetic.PairBatch(
                *(dist_lib.process_local_batch(mesh, a[lo:hi], (tcfg.batch_size,) + a.shape[1:]) for a in b)
            )
            state, loss = step_fn(state, g, gb)
            losses.append(loss)
        values = [float(v) for v in losses]  # the one device-to-host pull
        if dist.get_rank() == 0:
            print(
                f"mp_train ok: procs={dist.get_world_size()} devices={dist.get_world_size()} "
                f"mesh={{'data': {dp}, 'model': {tp}}} steps={steps} device={dev.type}",
                flush=True,
            )
            print("MP_LOSSES " + json.dumps([round(v, 6) for v in values]), flush=True)
    finally:
        dist_lib.shutdown()


if __name__ == "__main__":
    main()
