"""The benchmark of ``fenapack_tpu_torch`` (the port) on NVIDIA H100s.

``python3 -m pcdbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix or metric is a file of its own,
found by the name in ``BENCHMARK.json``:

  * ``configs/<name>.json`` (the configuration as it is run: source,
    sizes, solver settings, the seeded data, the limits of ``correct``)
    and ``configs/<name>.py`` (``target(cfg, device)``: its build call);
  * ``traffic/<name>.json``: the parameters of the one closed-loop
    generator (:mod:`.loop`);
  * ``metrics/<name>.py``: ``read(ctx)``, the number or None.

The reference that decides ``correct`` is under ``reference/`` and
imports nothing of the program.  Nothing here imports JAX or the JAX
package.
"""
