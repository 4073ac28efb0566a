"""``paddle.text`` of the port: the WMT translation datasets.  Imdb,
Imikolov, UCIHousing, Conll05st, Movielens and the tokenizer are not ported
yet (``ROADMAP.md`` Queue 1 item 12)."""
from .datasets import WMT14, WMT16  # noqa: F401

__all__ = ["WMT14", "WMT16"]
