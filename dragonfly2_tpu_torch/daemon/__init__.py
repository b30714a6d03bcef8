"""The port's peer daemon: the P2P data plane of dragonfly2_tpu/daemon/ —
peer engine, conductor, storage, source clients, piece pipeline, raw range
client, traffic shaper, upload server, prober, YAML config and the daemon
process (``python -m dragonfly2_tpu_torch.daemon.server``). The proxy,
object gateway, hdfs/oras sources and the mTLS data plane are still to port
(ROADMAP.md §1, 'Still to do' item 4)."""
