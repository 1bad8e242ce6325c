"""Device tag enrichment (port of deepflow_tpu/enrich)."""

from .platform import (  # noqa: F401
    ENRICH_FIELDS,
    PlatformInfoTable,
    PlatformState,
    enrich_docs,
)
