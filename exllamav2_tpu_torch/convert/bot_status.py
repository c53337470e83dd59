"""Machine-parseable conversion progress lines.

Copy of exllamav2_tpu/convert/bot_status.py.

Port of the reference's bot-status protocol (conversion/bot_status.py:1-17):
automation wrapping the converter greps stdout for
`[STATUS]{"stage": ..., "completion": 0.xxxx}[/STATUS]` lines instead of
scraping the human-readable log. Enabled with
`convert_model(..., status_output=True)` /
`python -m exllamav2_tpu_torch.convert --status_output`.
"""

from __future__ import annotations

import json

__all__ = ["print_stage"]


def print_stage(enabled: bool, stage: str, progress: int,
                max_progress: int) -> None:
    if not enabled:
        return
    status = {
        "stage": stage,
        "completion": round(progress / max(max_progress, 1), 4),
    }
    print("[STATUS]" + json.dumps(status) + "[/STATUS]", flush=True)
