"""``finalize.idle_share``: over the traced stretch, the share of its wall
time in which the card is idle while the host is inside the program's
``finalize`` span (the readout, the failure check and the layout copies), in
%; on a mesh the mean over its cards (``spans.idle_under``). None off the
card, or where the span did not run in the stretch."""

from benchmark.spans import idle_share_reader

read = idle_share_reader("finalize")
