"""A time limit of its own for one test case (no pytest-timeout here)."""

import functools
import threading


def within(seconds: float):
    """Fail the decorated case if its body runs longer than `seconds`.
    The body runs on a daemon thread; its exception is raised again."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as exc:   # raised again below
                    box["error"] = exc

            thread = threading.Thread(target=body, daemon=True,
                                      name=f"case-{fn.__name__}")
            thread.start()
            thread.join(seconds)
            assert not thread.is_alive(), (
                f"{fn.__name__} ran past its {seconds} s limit")
            if "error" in box:
                raise box["error"]
        return run
    return wrap
