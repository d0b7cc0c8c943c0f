"""train_images_per_s: the images of every step begun in the window,
over the time from the window's start to the end of the last of them."""


def read(run):
    if "steps" not in run.window:
        return None
    return run.window["images"] / run.window["seconds"]
