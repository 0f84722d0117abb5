"""service.images_per_batch: images over microbatches the service ran for
the window's requests (its own counters, ``ServiceStats``)."""


def read(rec):
    if not rec.service_batches:
        return None
    return rec.service_images / rec.service_batches
