"""``pack.host_ms``: the host's packing of one call's tables (``_pack``:
``gain_arrays``, ``beam_arrays``, ``seed_arrays`` and ``pack_arrays`` into
the page-locked buffer), the mean over the window of the program's
``pack`` span (``utils.timer.profiler``), in ms. Inside ``prepare``; a
sharded call packs once for every card."""

from benchmark.spans import span_ms_reader

read = span_ms_reader("pack")
