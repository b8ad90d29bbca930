"""Shared helpers for architecture configs."""

FULL_ATTN_SKIP = (
    ("long_500k",
     "pure full-attention arch: 524288-token context needs a sub-quadratic "
     "path; run only for ssm/hybrid families (DESIGN.md Sec. 5)"),
)
