"""Named host ranges in the port's serving and training paths.

``with span("engine.dispatch"):`` records one range under
``torch.profiler`` and nothing otherwise: tracing is on while a profiler
runs, with no switch of its own.  The range is PyTorch's fast record
function, which the profiler keeps as a ``cpu_op`` on whichever thread
opened it.  Unlike ``torch.profiler.record_function`` (a
``user_annotation``), it is not shown again on the card as a device
range, so a trace's device rows stay the work the card did.  With no
profiler running it costs under a microsecond an enter and exit.

There is no store here: the profiler's event list is the record, and
whoever reads the profiler writes it out.  Names are a fixed set with no
ids in them, so a reader can sum by name; an id goes in ``values``,
which the profiler keeps as the range's keyword values when it records
shapes (``record_shapes=True``).

The names and where they are opened:

  * ``engine.dispatch`` (``ServingEngine.dispatch``), holding
    ``engine.stage_in`` (pinned buffer, fill, H2D copy),
    ``ingress.booleanize`` and ``ingress.pack`` (``core/ingress.py``),
    ``classify.clauses`` (the eval path), ``classify.argmax`` and
    ``engine.stage_out`` (D2H copy, completion event);
  * ``engine.result`` (the first ``InFlightClassify.result``), holding
    ``engine.wait`` (the event wait) and ``engine.unpack``;
  * ``service.admit``, ``service.dispatch`` (dispatch thread) and
    ``service.complete`` (completion thread), with ``batch_id``;
  * ``gc.gen0`` .. ``gc.gen2``: a collector pause while a
    ``ServingService`` runs;
  * ``train.draws``, ``train.matmul``, ``train.feedback``,
    ``train.apply``: the TM trainer's step.
"""

from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast

__all__ = ["span"]


def span(name: str, **values) -> _RecordFunctionFast:
    """A context manager that records ``name`` as a host range while a
    profiler runs; ``values`` (ints or strings) ride on it as keyword
    values."""
    if values:
        return _RecordFunctionFast(name, (), values)
    return _RecordFunctionFast(name)
