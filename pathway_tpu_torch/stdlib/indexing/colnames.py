"""Internal column-name constants for index replies (reference:
python/pathway/stdlib/indexing/colnames.py — same names for template
compatibility)."""

_INDEX_REPLY = "_pw_index_reply"
_QUERY_ID = "_pw_query_id"
_NO_OF_MATCHES = "_pw_number_of_matches"
_PACKED_DATA = "_pw_packed_data"
_TOPK = "_pw_topk"

_MATCHED_ID = "_pw_index_reply_id"
_SCORE = "_pw_index_reply_score"
