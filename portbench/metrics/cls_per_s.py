"""cls_per_s: images whose results came back inside the window, over the
window's seconds."""


def read(rec):
    if rec.images_in_window is None:
        return None
    return rec.images_in_window / rec.window_s
