"""Share of the bf16 peak the served requests reach, in stablelm-3b.serve-longprompt."""
from perfbench.readers import serve_mfu as read  # noqa: F401
