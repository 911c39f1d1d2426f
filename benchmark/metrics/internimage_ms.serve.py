"""Stream ms a request in the InternImage backbone: ``vit_ms.serve``'s
reader, the program's span ``request/extract`` (``FGN._extract``: the
backbone over the queries and over the supports, whichever backbone it
is)."""

from pathlib import Path

from benchmark.harness.common import load_metric

_READER = load_metric("vit_ms.serve", Path(__file__).resolve().parents[1])
LAYER, UNIT, MOVES = _READER.LAYER, _READER.UNIT, _READER.MOVES
read = _READER.read
