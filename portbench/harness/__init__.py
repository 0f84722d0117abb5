"""The port's benchmark harness: everything the cells share.

``cell`` reads ``BENCHMARK.json`` and finds a cell's configuration, system
(``portbench/systems/<name>.py``), traffic mix, load generator and metric
readers by name.  For the ConvCoTM system: ``program`` builds the system
under test (``repro_torch``'s serving engine); ``reference`` is the plain
classify step that decides ``correct``; ``glyphs`` and ``model_state``
make the inputs and the model from the seed; ``readers`` holds the
kernels' operations and bytes.  For the LM decode: ``lm_reference`` makes
the seeded weights and is the plain float32 forward pass that decides
``correct``; ``lm_yardstick`` counts a call's model FLOPs.  ``card`` holds
the card's ceilings; ``trace`` reads the profiler; ``spans`` the
program's spans; ``guard`` is the check that no JAX module was loaded.
"""
