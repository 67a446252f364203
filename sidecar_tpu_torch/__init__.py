"""PyTorch/CUDA port of the gossip simulator (``sidecar_tpu`` is the
JAX reference it is held against, bit for bit).

This package imports ``torch`` and numpy only — never ``jax`` and
nothing from ``sidecar_tpu``.  Its module names mirror the reference's
so each counterpart is easy to find:

* ``ops/status.py``, ``ops/merge.py``, ``ops/ttl.py``,
  ``ops/suspicion.py``, ``ops/gossip.py``, ``ops/knobs.py``,
  ``ops/topology.py`` — the leaf ops, plain functions on tensors;
* ``ops/kernels/`` — the hand-written CUDA publish, board-row-gather
  and scatter-max kernels, their plain PyTorch versions, and the
  ``nvcc`` build;
* ``models/timecfg.py``, ``models/compressed.py``, ``models/exact.py``
  — the two models' rounds and their run methods;
* ``ops/trace.py``, ``ops/digest.py``, ``ops/delta.py``,
  ``ops/provenance.py``, ``models/planes.py`` — the telemetry planes
  that ride the run loop (``run_with_trace``, ``run_with_digest``,
  ``run_with_deltas``, ``run_with_provenance``);
* ``metrics.py`` — the process registry of counters, gauges, timers and
  histograms; ``telemetry/cost.py`` — the round's phase scopes for
  ``torch.profiler``;
* ``parallel/mesh.py``, ``parallel/sharded_compressed.py``,
  ``parallel/sharded.py`` — the node-sharded twins of both models over
  a shard group;
* ``chaos/plan.py``, ``chaos/adversary.py``, ``chaos/sim_inject.py`` —
  the FaultPlan and AdversaryPlan and ``ChaosExactSim``, the exact
  round under them;
* ``fleet/batch.py``, ``fleet/rounds.py``, ``fleet/engine.py``,
  ``fleet/grid.py`` — the scenario fleet: S scenarios of one model in
  one batched round (``FleetSim``);
* ``autopilot/fit.py``, ``autopilot/objective.py``,
  ``autopilot/search.py``, ``autopilot/controller.py`` — the autopilot:
  fit the conditions, score knob bundles in fleet dispatches, replay the
  winner; ``telemetry/slo.py`` — the SLO rules it scores against;
* ``sim/scenarios.py`` — the BASELINE scenario configs 1–6, ``run_all``
  and the registry and protocol-config validation;
  ``sim/checkpoint.py`` — save and resume a run's state (and its
  generator);
* ``bridge/sim_bridge.py`` — the simulator bridge: ``SimBridge``
  (``simulate``, ``sweep``, ``autopilot_recommend``) and its HTTP server
  ``serve_bridge``; with what it reads: ``catalog/`` (the catalog and
  its wire form, the flap damper), ``service.py`` (status names, the
  service record), ``ops/suspicion.py``'s ``ProtocolParams`` and
  ``telemetry/span.py``;
* ``catalog/state.py``'s writer path, ``ops/digest.py``'s live ladder,
  ``transport/antientropy.py``, ``query/``, ``catalog/url_listener.py``,
  ``telemetry/coherence.py``, ``telemetry/propagation.py``,
  ``runtime/looper.py`` and ``output.py`` — the live catalog: the
  writer, digest-directed anti-entropy sessions, the versioned query
  plane and its URL listener, and the monitors the writer feeds (host
  code);
* ``sim/oracle.py`` — the sequential NumPy oracle of the exact round;
* ``convert.py`` — moving state, params and graphs across from the
  reference's numpy form.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``), where every kernel call takes its plain
PyTorch version.
"""
