"""Framework substrate of the port (its own copies, no JAX): dtypes and
places, flags, errors, execution mode, nan/inf debugging, meta validation,
the random streams and ``load`` / ``save``, exported as the JAX package's
``paddle_tpu.framework`` exports them."""
from . import dtype, errors, flags, io, random  # noqa: F401
from .dtype import (CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace,  # noqa: F401
                    Place, TPUPlace, convert_dtype, get_device,
                    is_compiled_with_tpu, set_device)
from .errors import EnforceNotMet, enforce  # noqa: F401
from .flags import define_flag, get_flags, set_flags  # noqa: F401
from .io import load, save  # noqa: F401
from .random import seed  # noqa: F401
