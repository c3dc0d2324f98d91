"""Post-processing toolkit for HaMMLET output (Python-3 re-creation of the
reference's bin/pyhammlet Python-2 package: io, RLE, plotting); the port's
own copy of hammlet_tpu/pyhammlet. matplotlib is imported only where a plot
is drawn."""

from hammlet_tpu_torch.pyhammlet.rle import RunLengthArray, shatter, subdiff  # noqa: F401
from hammlet_tpu_torch.pyhammlet.io import (  # noqa: F401
    readBlockSizes,
    readCompressedStateSequences,
    readMarginals,
)
