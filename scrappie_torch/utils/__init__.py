"""Host helpers of the port: the signal statistics (maths), tracing,
validation and sequence comparison. Re-exports the maths helpers, as
scrappie_tpu/utils/__init__.py does."""

from scrappie_torch.utils.maths import (  # noqa: F401
    logsumexp2,
    loglaplace,
    plogistic,
    madf,
    medianf,
    quantilef,
    medmad_normalise,
    studentise,
)
