"""The port's daemon package. Only ``engine.InProcessSchedulerClient`` is
here so far: the swarm simulator reaches each scheduler through it. The peer
engine, conductor, storage, upload server and the daemon's RPC front are not
ported yet (ROADMAP.md §1, queue item 4)."""
