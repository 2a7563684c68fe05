from archnemesis_tpu_torch.cfg.logs import (
    pkg_logger,
    set_packagewide_level,
    push_packagewide_level,
    pop_packagewide_level,
    quiet,
)

__all__ = [
    "pkg_logger",
    "set_packagewide_level",
    "push_packagewide_level",
    "pop_packagewide_level",
    "quiet",
]
