"""The port's peer daemon, the port of dragonfly2_tpu/daemon/: peer engine,
conductor, storage, source clients (http(s), file, s3, oss, hdfs, oras and
plugins), piece pipeline, raw range client, traffic shaper, upload server
(plain or mTLS), prober, the proxy and registry mirror, the object gateway,
YAML config and the daemon process (``python -m
dragonfly2_tpu_torch.daemon.server``)."""
