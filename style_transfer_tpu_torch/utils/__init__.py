from .ema import EMAState, ema_get, ema_init, ema_update  # noqa: F401
from .scales import gen_scales, get_safe_scale, size_to_fit  # noqa: F401
from .trace import STIterate, TraceRecorder  # noqa: F401
