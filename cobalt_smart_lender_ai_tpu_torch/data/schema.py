"""LendingClub column schema: every column-name constant the port relies on.

A copy of the reference package's ``data/schema.py`` (the port imports
nothing from it): the cleaning, tokenizing, engineering and training column
lists, the label map, the `/predict` request contract and the categorical
vocabularies of the synthetic generator. The values are the reference's,
verbatim.
"""

from __future__ import annotations

# --- Cleaning stage (reference: src/data_preprocessing/clean_data.py) ---------

#: clean_data.py:102 — index-artifact columns dropped first.
UNNAMED_COLS = ("Unnamed: 0.1", "Unnamed: 0")

#: clean_data.py:133 — "unnecessary" columns dropped during cleaning.
CLEAN_UNNECESSARY_COLS = (
    "next_pymnt_d",
    "last_pymnt_d",
    "last_credit_pull_d",
    "mths_since_recent_revol_delinq",
    "il_util",
    "all_util",
    "mths_since_recent_bc_dlq",
)

#: clean_data.py:140 — missing assumed to mean zero.
FILL_ZERO_COLS = ("inq_last_12m", "open_acc_6m", "chargeoff_within_12_mths")

#: clean_data.py:117 — hardship_status null fill token.
HARDSHIP_FILL = "No Hardship"

# --- Stringy frontier (data/device_pipeline.py) -------------------------------
# The only columns the host parses to *numbers* during tokenization; every
# other object column becomes sorted-vocabulary integer codes and all further
# work runs as jitted columnar ops on device. Each entry names the pandas-path
# transform it mirrors, so the two paths stay in lockstep.

#: parse_term at clean rule 4 (clean.py).
FRONTIER_TERM_COLS = ("term",)
#: parse_percent at clean rule 4 / prepare (clean.py, features.py).
FRONTIER_PERCENT_COLS = ("int_rate", "revol_util")
#: emp_length regex extract at prepare (features.py).
FRONTIER_EMP_COLS = ("emp_length",)
#: "%b-%Y" date -> age-in-days at prepare (features.py).
FRONTIER_DATE_COLS = ("earliest_cr_line",)

# --- Feature-engineering stage (src/data_preprocessing/feature_engineering.py) -

#: feature_engineering.py:57 — columns that leak the label.
FE_LEAKAGE_COLS = ("recoveries", "collection_recovery_fee", "debt_settlement_flag")

#: feature_engineering.py:58-62 — identifier/high-cardinality/useless columns.
FE_USELESS_COLS = (
    "id",
    "url",
    "title",
    "zip_code",
    "addr_state",
    "emp_title",
    "issue_d",
    "initial_list_status",
    "hardship_flag",
    "sub_grade",
    "next_pymnt_d",
    "last_credit_pull_d",
    "pymnt_plan",
)

#: feature_engineering.py:85-94 — loan_status -> binary default label.
LOAN_STATUS_MAP = {
    "Fully Paid": 0,
    "Current": 0,
    "Issued": 0,
    "In Grace Period": 0,
    "Late (16-30 days)": 0,
    "Late (31-120 days)": 1,
    "Charged Off": 1,
    "Default": 1,
}

#: feature_engineering.py:118-130 — skewed columns that get log1p.
LOG_COLS = (
    "loan_amnt", "funded_amnt", "funded_amnt_inv", "int_rate", "installment",
    "annual_inc", "dti", "fico_range_low", "fico_range_high",
    "mths_since_last_delinq", "open_acc", "total_acc", "total_pymnt",
    "total_pymnt_inv", "total_rec_prncp", "total_rec_int", "total_rec_late_fee",
    "last_pymnt_amnt", "acc_now_delinq", "tot_coll_amt", "tot_cur_bal",
    "total_rev_hi_lim", "earliest_cr_line_days", "acc_open_past_24mths",
    "avg_cur_bal", "bc_open_to_buy", "mo_sin_old_rev_tl_op",
    "mo_sin_rcnt_rev_tl_op", "mo_sin_rcnt_tl", "mort_acc",
    "mths_since_recent_bc", "mths_since_recent_inq",
    "mths_since_recent_revol_delinq", "num_accts_ever_120_pd",
    "num_actv_bc_tl", "num_actv_rev_tl", "num_bc_sats", "num_bc_tl",
    "num_il_tl", "num_op_rev_tl", "num_rev_accts", "num_rev_tl_bal_gt_0",
    "num_sats", "num_tl_op_past_12m", "pub_rec_bankruptcies",
    "tot_hi_cred_lim", "total_bal_ex_mort", "total_bc_limit",
    "total_il_high_credit_limit", "revol_util",
)

#: feature_engineering.py:142-147 — categorical columns one-hot encoded for the
#: tree dataset (pandas get_dummies drop_first=True semantics).
ONE_HOT_COLS = (
    "grade",
    "home_ownership",
    "verification_status",
    "purpose",
    "application_type",
    "hardship_status",
)

# --- Training stage (src/model_train_test/model_tree_train_test.py) -----------

#: model_tree_train_test.py:82-86 — post-engineering leakage columns removed
#: before the train/test split.
TRAIN_LEAKAGE_COLS = (
    "total_rec_late_fee", "total_rec_prncp", "out_prncp", "last_pymnt_amnt",
    "last_pymnt_d", "funded_amnt_inv", "funded_amnt", "out_prncp_inv",
    "total_pymnt", "total_pymnt_inv", "last_pymnt_d_days",
    "last_credit_pull_d_days", "issue_d_days", "total_rec_int",
)

LABEL_COL = "loan_default"

# --- Serving contract (the `/predict` request schema) -----------------------

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

# --- Categorical vocabularies (observed LendingClub values; used by the
# --- synthetic generator and the label-encoding path) --------------------------

GRADES = ("A", "B", "C", "D", "E", "F", "G")
HOME_OWNERSHIP = ("MORTGAGE", "RENT", "OWN", "ANY", "OTHER", "NONE")
VERIFICATION_STATUS = ("Not Verified", "Source Verified", "Verified")
PURPOSES = (
    "debt_consolidation", "credit_card", "home_improvement", "other",
    "major_purchase", "medical", "small_business", "car", "moving",
    "vacation", "house", "wedding", "renewable_energy", "educational",
)
APPLICATION_TYPES = ("Individual", "Joint App")
HARDSHIP_STATUS = ("ACTIVE", "BROKEN", "COMPLETE", "COMPLETED", "No Hardship")
EMP_LENGTHS = (
    "< 1 year", "1 year", "2 years", "3 years", "4 years", "5 years",
    "6 years", "7 years", "8 years", "9 years", "10+ years",
)
TERMS = (" 36 months", " 60 months")
