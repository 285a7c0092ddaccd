"""IO helpers (the port's copy of detectron_tpu/utils/io.py; reference:
lib/utils/io.py :: save_object, cache_url)."""

import hashlib
import logging
import os
import pickle

logger = logging.getLogger(__name__)

_DETECTRON_S3_BASE_URL = "https://dl.fbaipublicfiles.com/detectron"


def save_object(obj, file_name):
    """Pickle an object to disk (HIGHEST_PROTOCOL)."""
    file_name = os.path.abspath(file_name)
    with open(file_name, "wb") as f:
        pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)


def cache_url(url_or_file, cache_dir=None):
    """Map a Detectron model-zoo URL to a local cache path, downloading it
    if absent; a local path is returned as it is. Where the host has no
    network the file must already be in the cache, and a clear error says
    where to put it."""
    cache_dir = cache_dir or os.path.expanduser("~/.detectron_tpu_cache")
    is_url = url_or_file.startswith(("http://", "https://"))
    if not is_url:
        return url_or_file
    url = url_or_file
    cache_path = os.path.join(
        cache_dir, url.replace(_DETECTRON_S3_BASE_URL + "/", ""))
    if os.path.exists(cache_path):
        return cache_path
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    try:
        from urllib.request import urlretrieve

        logger.info("Downloading %s -> %s", url, cache_path)
        urlretrieve(url, cache_path)
        return cache_path
    except Exception as e:
        raise IOError(
            "Cannot fetch {} (no network?). Place the file at {} manually."
            .format(url, cache_path)) from e


def md5(path):
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
