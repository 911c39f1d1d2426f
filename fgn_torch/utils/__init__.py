"""Host-side helpers: directories, JSON, pickle and numpy files, log
timestamps."""

from fgn_torch.utils.timers import (
    time_log_fancy,
    datetime_now,
    datetime_log_fancy,
    datetime_diff,
    datetime_diff_ms,
)
