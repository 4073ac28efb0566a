"""Reader-factory plumbing of the legacy dataset modules."""
from __future__ import annotations

import numpy as np


def make_readers(make_train, make_test, to_tuple):
    """(train, test) reader factories over Dataset constructors."""
    def _reader(mk):
        def factory():
            def reader():
                ds = mk()
                for i in range(len(ds)):
                    yield to_tuple(ds[i])
            return reader
        return factory
    return _reader(make_train), _reader(make_test)


def img_label(sample):
    img, label = sample
    return (np.asarray(img, np.float32) / 255.0,
            int(np.asarray(label).reshape(-1)[0]))
