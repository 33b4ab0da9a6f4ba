"""Examples trained in the window over its host seconds, the window
ending when the device has finished its last step."""


def read(rec):
    if not rec.examples or not rec.window_s:
        return None
    return rec.examples / rec.window_s
