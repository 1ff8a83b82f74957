"""Shared Google-auth bearer token resolution for REST transports
(gdrive, pubsub): accepts a raw token string (tests) or any
google-auth credentials object (refreshes when missing/expired)."""

from __future__ import annotations


def bearer_token(credentials) -> str:
    if isinstance(credentials, str):
        return credentials
    token = getattr(credentials, "token", None)
    if token is None or getattr(credentials, "expired", False):
        import google.auth.transport.requests

        credentials.refresh(google.auth.transport.requests.Request())
        token = credentials.token
    return token
