"""Cloud object localization (gs:// s3:// -> local files).

Counterpart of ``variantcalling_tpu/utils/cloud.py``. Local paths pass
through untouched; remote URIs are localized into a cache directory by the
gsutil/gcloud/aws CLIs where they are on ``PATH``, each bounded by
``VCTPU_CLOUD_TIMEOUT`` seconds. The port runs where there may be no
network, so failure is explicit: :func:`cloud_sync` raises,
:func:`optional_cloud_sync` returns the URI unchanged with a warning.
``google.auth`` and ``requests`` are imported only by :func:`get_gcs_token`,
on the paths that need them.
"""

from __future__ import annotations

import logging
import os
import subprocess

from variantcalling_tpu_torch import knobs

log = logging.getLogger(__name__)

DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache", "vctpu_cloud")


def is_remote(path: str) -> bool:
    return str(path).startswith(("gs://", "s3://"))


def _local_target(uri: str, cache_dir: str) -> str:
    scheme, rest = uri.split("://", 1)
    return os.path.join(cache_dir, scheme, rest)


def cloud_sync(uri: str, cache_dir: str = DEFAULT_CACHE, force: bool = False) -> str:
    """Localize a gs:// or s3:// object; local paths pass through."""
    if not is_remote(uri):
        return uri
    target = _local_target(uri, cache_dir)
    if os.path.exists(target) and not force:
        return target
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = target + ".tmp"
    if uri.startswith("gs://"):
        cmds = [["gsutil", "-q", "cp", uri, tmp], ["gcloud", "storage", "cp", uri, tmp]]
    else:
        cmds = [["aws", "s3", "cp", "--quiet", uri, tmp]]
    last_err: Exception | None = None
    for cmd in cmds:
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=knobs.get_int("VCTPU_CLOUD_TIMEOUT"))
            os.replace(tmp, target)
            return target
        except (OSError, subprocess.SubprocessError) as e:  # tool missing / copy failed / hung
            last_err = e
    raise RuntimeError(f"could not localize {uri}: no working cloud CLI ({last_err})")


def optional_cloud_sync(uri: str, cache_dir: str = DEFAULT_CACHE) -> str:
    """:func:`cloud_sync`, or the URI unchanged (with a warning) where localization fails."""
    try:
        return cloud_sync(uri, cache_dir)
    except RuntimeError as e:
        log.warning("cloud localization failed, passing URI through: %s", e)
        return uri


GOOGLE_APPLICATION_CREDENTIALS = "GOOGLE_APPLICATION_CREDENTIALS"
GCS_OAUTH_TOKEN = "GCS_OAUTH_TOKEN"
_GCS_SCOPE = "https://www.googleapis.com/auth/devstorage.read_only"


def get_gcs_token(verify: bool = False) -> str:
    """A GCS access token: minted through ``google.auth`` where
    ``GOOGLE_APPLICATION_CREDENTIALS`` is set, else ``GCS_OAUTH_TOKEN``, else
    ValueError. ``verify=True`` also checks it against Google's tokeninfo
    endpoint (a network call, made only when asked)."""
    if GOOGLE_APPLICATION_CREDENTIALS in os.environ:
        from google.auth import default
        from google.auth.transport.requests import Request

        credentials, _project = default(scopes=[_GCS_SCOPE])
        credentials.refresh(Request())
        token = credentials.token
    elif GCS_OAUTH_TOKEN in os.environ:
        token = os.environ[GCS_OAUTH_TOKEN]
    else:
        raise ValueError(
            f"Could not generate gcs token: set {GOOGLE_APPLICATION_CREDENTIALS} "
            f"(to mint) or {GCS_OAUTH_TOKEN} (pre-existing token)"
        )
    if verify:
        import requests

        resp = requests.post(
            "https://www.googleapis.com/oauth2/v1/tokeninfo",
            data=f"access_token={token}",
            headers={"content-type": "application/x-www-form-urlencoded"},
            timeout=30,
        )
        if not resp.ok:
            raise ValueError(f"Could not verify token: {resp.text}")
        if not resp.json().get("expires_in", 0) > 0:
            raise ValueError("token expired")
    return token
