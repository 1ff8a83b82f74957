"""pw.io.minio — MinIO connector (reference: python/pathway/io/minio —
the S3 protocol against a path-style MinIO endpoint)."""

from __future__ import annotations

from pathway_tpu_torch.io._s3 import AwsS3Settings
from pathway_tpu_torch.io.s3 import read as _s3_read, write as _s3_write

__all__ = ["MinIOSettings", "read", "write"]


class MinIOSettings:
    """MinIO connection settings (reference: io/minio/__init__.py:15 —
    same constructor surface; path-style access defaults on)."""

    def __init__(
        self,
        endpoint,
        bucket_name,
        access_key,
        secret_access_key,
        *,
        with_path_style=True,
        region=None,
    ):
        self.endpoint = endpoint
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.region = region

    def create_aws_settings(self) -> AwsS3Settings:
        return AwsS3Settings(
            endpoint=self.endpoint,
            bucket_name=self.bucket_name,
            access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            with_path_style=self.with_path_style,
            region=self.region,
        )


def read(
    path: str,
    minio_settings: MinIOSettings,
    format: str = "csv",
    **kwargs,
):
    return _s3_read(
        path, format, aws_s3_settings=minio_settings.create_aws_settings(),
        **kwargs,
    )


def write(table, path: str, minio_settings: MinIOSettings, **kwargs) -> None:
    return _s3_write(
        table, path, aws_s3_settings=minio_settings.create_aws_settings(),
        **kwargs,
    )
