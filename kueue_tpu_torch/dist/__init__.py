"""Distributed control plane: real OS processes under a seeded
supervisor.

The r16–r19 stack is crash-consistent but single-process — every soak
kills and recovers a driver *inside* one interpreter.  This package
splits the control plane the way PAPER.md's Kueue deployment does
(controller-manager processes whose durable state lives outside the
process) and proves the same zero-lost/zero-duplicated guarantees when
the processes are actually SIGKILLed:

- ``supervisor``: spawn/monitor/SIGKILL child processes under a
  deterministic schedule (chaos site ``dist.kill``), with bound-port
  handoff and readiness polling instead of sleeps;
- ``proxy``: a listen-and-forward socket proxy injecting transport
  faults at the wire (chaos site ``dist.proxy_fault``: connection
  resets, added latency, truncated writes, blackholes);
- ``serving``: LocalQueue-sharded front-end helpers — shard routing,
  the shard HTTP client, and shard-process recovery from its
  IngestJournal + CycleWAL;
- ``worker``: federation-worker process recovery from its
  ManifestJournal + CycleWAL full-history replay;
- ``child``: the ``python -m kueue_tpu.dist.child`` entry point every
  supervised process runs (roles: shard, worker, submitter).
"""
