"""The port's benchmark harness: everything the cells share.

``cell`` reads ``BENCHMARK.json`` and finds a cell's configuration, traffic
mix, load generator and metric readers by name; ``program`` builds the
system under test (``repro_torch``'s serving engine); ``reference`` is the
plain classify step that decides ``correct``; ``glyphs`` and
``model_state`` make the inputs and the model from the seed; ``card``
holds the card's ceilings; ``trace`` reads the profiler; ``guard`` is the
check that no JAX module was loaded.
"""
