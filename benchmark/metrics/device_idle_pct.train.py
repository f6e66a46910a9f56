"""The device's idle share of the traced steps' window: one minus the
union of its operations' intervals over the window."""


def read(view):
    if view.window_s <= 0 or not view.device_ops:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
