"""pw.io.s3_csv — CSV-from-S3 convenience wrapper (reference:
python/pathway/io/s3_csv — delegates to the S3 scanner with csv format)."""

from __future__ import annotations

from pathway_tpu_torch.io.s3 import AwsS3Settings, read as _s3_read

__all__ = ["AwsS3Settings", "read"]


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    schema=None,
    mode: str = "streaming",
    csv_settings=None,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    **kwargs,
):
    return _s3_read(
        path,
        "csv",
        aws_s3_settings=aws_s3_settings,
        schema=schema,
        mode=mode,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        **kwargs,
    )
