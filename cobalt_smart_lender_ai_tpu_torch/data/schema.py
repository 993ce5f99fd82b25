"""The `/predict` request contract: the deployed model's 20 features.

A copy of the serving subset of the reference package's ``data/schema.py``
(the port imports nothing from it).
"""

from __future__ import annotations

#: The 20 features of the deployed model, in serving order. Two names contain
#: spaces (pandas get_dummies output) and are aliased in the request schema.
SERVING_FEATURES = (
    "loan_amnt",
    "term",
    "installment",
    "fico_range_low",
    "last_fico_range_high",
    "open_il_12m",
    "open_il_24m",
    "max_bal_bc",
    "num_rev_accts",
    "pub_rec_bankruptcies",
    "emp_length_num",
    "earliest_cr_line_days",
    "grade_E",
    "home_ownership_MORTGAGE",
    "verification_status_Verified",
    "application_type_Joint App",
    "hardship_status_BROKEN",
    "hardship_status_COMPLETE",
    "hardship_status_COMPLETED",
    "hardship_status_No Hardship",
)

#: Python-identifier-safe aliases of the two names with spaces.
SERVING_FIELD_ALIASES = {
    "application_type_Joint_App": "application_type_Joint App",
    "hardship_status_No_Hardship": "hardship_status_No Hardship",
}

#: Serving fields typed `int` in the request schema (one-hot indicators).
#: Everything else is a float.
SERVING_INT_FEATURES = (
    "grade_E",
    "home_ownership_MORTGAGE",
    "verification_status_Verified",
    "application_type_Joint App",
    "hardship_status_BROKEN",
    "hardship_status_COMPLETE",
    "hardship_status_COMPLETED",
    "hardship_status_No Hardship",
)
