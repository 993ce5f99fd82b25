"""Synthetic LendingClub-schema data generator: the port's copy of the
reference's ``data/synthetic.py``, returning a pandas-free `RawFrame`.

For the same ``(n_rows, seed)`` the frame has the reference frame's columns,
in its order, with its cells: the same ``np.random.default_rng`` draws in
the same order. What the reference builds row by row in Python (the
``url`` strings, the ``"Mon-YYYY"`` dates, ``sub_grade``, the percent
strings' lists) is built here as numpy gathers or one formatting pass, so a
2.3M-row frame takes seconds, not minutes. String columns with missing cells
are ``U`` arrays with a missing mask (the reference's ``None``).

The reference's raw data lives behind DVC pointers to a private S3 bucket
and cannot be fetched offline. This module generates a raw frame with the
same observable schema the pipeline consumes — including the string quirks the cleaning stage must handle
(`" 36 months"`, `"13.56%"`, `"Apr-2005"`, `"10+ years"`, `"< 1 year"`),
`Unnamed: 0` index artifacts, >70%-null junk columns, duplicate rows, and a
`loan_status` column covering every key of the label map
(`feature_engineering.py:85-94`).

The default label is planted as a Bernoulli draw from a nonlinear
risk score over fico / dti / int_rate / grade / term / utilization with
interactions, so tree models meaningfully beat linear ones and tuned models can
reach the reference's headline AUC regime (~0.95, BASELINE.md).
"""

from __future__ import annotations

import numpy as np

from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame

_MONTHS = ("Jan", "Feb", "Mar", "Apr", "May", "Jun",
           "Jul", "Aug", "Sep", "Oct", "Nov", "Dec")


def _sigmoid(z: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-z))


def _lognormal(rng, mean: float, sigma: float, n: int) -> np.ndarray:
    return rng.lognormal(mean, sigma, n)


def synthetic_lendingclub_frame(
    n_rows: int = 10_000,
    seed: int = 0,
    *,
    missing_junk_cols: int = 3,
    duplicate_fraction: float = 0.002,
    signal_scale: float = 3.5,
) -> RawFrame:
    """Build a raw-schema frame of ``n_rows`` loans (plus a few duplicates)."""
    rng = np.random.default_rng(seed)
    n = n_rows

    # --- Core credit variables with realistic correlation structure ----------
    fico_low = np.clip(rng.normal(695, 32, n), 630, 845).round(0)
    fico_high = fico_low + 4.0
    # last_fico drifts from origination fico; big drops signal distress.
    fico_drift = rng.normal(0, 45, n) - 20 * (rng.random(n) < 0.15)
    last_fico_high = np.clip(fico_high + fico_drift, 300, 850).round(0)

    grade_q = np.clip(
        (850 - fico_low) / 40 + rng.normal(0, 1.0, n), 0, 6.999
    )
    grade_idx = grade_q.astype(int)  # 0..6 → A..G
    sub = rng.integers(1, 6, n)

    int_rate = np.clip(0.05 + 0.028 * grade_q + rng.normal(0, 0.008, n), 0.05, 0.31)
    term_is_60 = rng.random(n) < _sigmoid(0.8 * (grade_q - 3.0))
    loan_amnt = np.clip(_lognormal(rng, 9.45, 0.55, n), 1000, 40000).round(-2)
    term_months = np.where(term_is_60, 60, 36)
    monthly_rate = int_rate / 12
    installment = (
        loan_amnt * monthly_rate / (1 - (1 + monthly_rate) ** (-term_months))
    ).round(2)

    annual_inc = np.clip(_lognormal(rng, 11.1, 0.6, n), 4000, 2_000_000).round(0)
    dti = np.clip(rng.normal(18 + 2.2 * grade_q, 8, n), 0, 60).round(2)
    revol_util = np.clip(rng.normal(0.42 + 0.05 * grade_q, 0.25, n), 0, 1.5)

    open_acc = np.clip(rng.poisson(11, n), 1, 60)
    total_acc = open_acc + rng.poisson(12, n)
    mort_acc = rng.poisson(1.4, n)
    pub_rec_bankruptcies = (rng.random(n) < 0.11).astype(float)
    emp_len_idx = rng.integers(0, len(schema.EMP_LENGTHS), n)
    cr_age_days = np.clip(rng.normal(5800, 2600, n), 400, 22000)

    open_il_12m = rng.poisson(0.7, n).astype(float)
    open_il_24m = open_il_12m + rng.poisson(0.8, n)
    max_bal_bc = np.clip(_lognormal(rng, 8.3, 1.0, n), 0, 150_000).round(0)
    num_rev_accts = np.clip(rng.poisson(14, n), 1, 80).astype(float)

    # --- Planted default risk (nonlinear, with interactions) -----------------
    # The deterministic score is scaled so the Bayes-optimal AUC on observable
    # features lands in the reference's headline regime (~0.95, BASELINE.md);
    # at the default signal_scale an sklearn HistGBT oracle measures ~0.96
    # test AUC and ~21% positive rate on 20k rows.
    z_core = (
        9.0 * (int_rate - 0.13)
        + 0.035 * (dti - 18)
        + 0.9 * (revol_util - 0.45)
        + 0.55 * term_is_60
        - 0.011 * (fico_low - 695)
        - 0.020 * (last_fico_high - fico_high + 20)  # strong distress signal
        + 0.25 * pub_rec_bankruptcies
        - 0.00003 * (cr_age_days - 5800) / 365 * 30
        + 0.35 * ((dti > 32) & (revol_util > 0.8))  # interaction cliff
        + 0.30 * ((last_fico_high < 620).astype(float))
        - 0.08 * np.log1p(annual_inc / 1000)
        + 0.08 * np.log1p(loan_amnt / 1000)
    )
    # Center z_core (empirical mean ~0.65) so scaling it does not shift the
    # logit mean. The base rate still drifts with signal_scale (E[sigmoid]
    # depends on logit variance): ~20% — the LendingClub regime — holds at
    # the default scale, not at arbitrary scales.
    z = (
        -4.1
        + signal_scale * (z_core - 0.65)
        + rng.normal(0, 0.55, n)  # irreducible noise keeps AUC < 1
    )
    default = (rng.random(n) < _sigmoid(z)).astype(int)

    # loan_status covering every key of LOAN_STATUS_MAP (feature_engineering.py:85-94)
    pos_states = ["Charged Off", "Default", "Late (31-120 days)"]
    neg_states = ["Fully Paid", "Current", "Issued", "In Grace Period",
                  "Late (16-30 days)"]
    status = np.where(
        default == 1,
        rng.choice(pos_states, n, p=[0.78, 0.05, 0.17]),
        rng.choice(neg_states, n, p=[0.55, 0.40, 0.01, 0.03, 0.01]),
    )

    # --- Post-origination / leakage columns (must be dropped by the pipeline) -
    paid_frac = np.where(default == 1, rng.beta(1.2, 3.0, n), rng.beta(6, 1.5, n))
    total_pymnt = (loan_amnt * (1 + int_rate) * paid_frac).round(2)
    recoveries = np.where(default == 1, loan_amnt * rng.beta(1.1, 8, n), 0.0).round(2)

    def _date_str(days_ago: np.ndarray) -> np.ndarray:
        base = np.datetime64("2020-09-01")
        dates = base - days_ago.astype("timedelta64[D]")
        y = dates.astype("datetime64[Y]").astype(int) + 1970
        m = dates.astype("datetime64[M]").astype(int) % 12
        y0 = int(y.min())
        table = np.array(
            [f"{mon}-{yy}" for yy in range(y0, int(y.max()) + 1) for mon in _MONTHS]
        )
        return table[(y - y0) * 12 + m]

    missing: dict[str, np.ndarray] = {}

    def _where_none(mask: np.ndarray, name: str, values: np.ndarray) -> np.ndarray:
        """The reference's ``np.where(mask, None, values)`` for string
        values: the values, with ``mask`` recorded as missing."""
        missing[name] = np.asarray(mask, bool)
        return np.asarray(values, dtype=str)

    frame = {
        "Unnamed: 0.1": np.arange(n) + 1_000_000,  # second index artifact
        "Unnamed: 0": np.arange(n),
        "id": 10_000_000 + np.arange(n),
        "url": np.char.add(
            "https://lendingclub.com/loan/", np.arange(n).astype(f"U{len(str(max(n - 1, 0)))}")
        ),
        "title": rng.choice(["Debt consolidation", "Credit card refinancing",
                             "Home improvement", "Other"], n),
        "zip_code": rng.choice(["941xx", "112xx", "606xx", "750xx", "331xx"], n),
        "addr_state": rng.choice(["CA", "NY", "TX", "FL", "IL", "WA"], n),
        "emp_title": rng.choice(["Teacher", "Manager", "Driver", "Nurse", "Engineer",
                                 "Owner", ""], n),
        # ~7% missing like the real table (cell 26: 6,950/100,000) -> the NN
        # path imputes emp_length_num and adds its _NA indicator (cell 18).
        "emp_length": _where_none(
            rng.random(n) < 0.07, "emp_length", np.array(schema.EMP_LENGTHS)[emp_len_idx],
        ),
        "issue_d": _date_str(rng.integers(30, 4000, n).astype(float)),
        "earliest_cr_line": _date_str(cr_age_days),
        "initial_list_status": rng.choice(["w", "f"], n),
        "pymnt_plan": np.where(rng.random(n) < 0.995, "n", "y"),
        "hardship_flag": np.where(rng.random(n) < 0.98, "N", "Y"),
        "grade": np.array(schema.GRADES)[grade_idx],
        "sub_grade": np.array([f"{g}{s}" for g in schema.GRADES for s in range(1, 6)])[
            grade_idx * 5 + sub - 1
        ],
        "term": np.where(term_is_60, " 60 months", " 36 months"),
        "int_rate": np.char.mod("%.2f%%", int_rate * 100),
        "loan_amnt": loan_amnt,
        "funded_amnt": loan_amnt,
        "funded_amnt_inv": (loan_amnt * rng.uniform(0.97, 1.0, n)).round(2),
        "installment": installment,
        "annual_inc": annual_inc,
        "dti": dti,
        "fico_range_low": fico_low,
        "fico_range_high": fico_high,
        "last_fico_range_high": last_fico_high,
        "last_fico_range_low": np.clip(last_fico_high - 4, 300, 850),
        "revol_util": _where_none(
            rng.random(n) < 0.004, "revol_util", np.char.mod("%.1f%%", revol_util * 100),
        ),
        "revol_bal": np.clip(_lognormal(rng, 9.2, 1.1, n), 0, 500_000).round(0),
        "open_acc": open_acc.astype(float),
        "total_acc": total_acc.astype(float),
        "mort_acc": mort_acc.astype(float),
        "pub_rec": (pub_rec_bankruptcies + (rng.random(n) < 0.05)).round(0),
        "pub_rec_bankruptcies": pub_rec_bankruptcies,
        # open_il_12m/open_il_24m/max_bal_bc/num_rev_accts join the blocked
        # updates below (shared-missingness structure).
        "loan_status": status,
        "application_type": rng.choice(schema.APPLICATION_TYPES, n, p=[0.95, 0.05]),
        "home_ownership": rng.choice(schema.HOME_OWNERSHIP, n,
                                     p=[0.49, 0.39, 0.11, 0.004, 0.004, 0.002]),
        "verification_status": rng.choice(schema.VERIFICATION_STATUS, n),
        "purpose": rng.choice(schema.PURPOSES, n),
        # Leakage block (FE_LEAKAGE_COLS + TRAIN_LEAKAGE_COLS)
        "recoveries": recoveries,
        "collection_recovery_fee": (recoveries * 0.18).round(2),
        "debt_settlement_flag": np.where(default == 1,
                                         np.where(rng.random(n) < 0.3, "Y", "N"), "N"),
        "total_pymnt": total_pymnt,
        "total_pymnt_inv": (total_pymnt * rng.uniform(0.97, 1.0, n)).round(2),
        "total_rec_prncp": (total_pymnt * rng.uniform(0.6, 0.95, n)).round(2),
        "total_rec_int": (total_pymnt * rng.uniform(0.05, 0.4, n)).round(2),
        "total_rec_late_fee": np.where(default == 1,
                                       rng.exponential(8, n), 0.0).round(2),
        "last_pymnt_amnt": (installment * rng.uniform(0.5, 30, n)).round(2),
        "last_pymnt_d": _date_str(rng.integers(10, 2000, n).astype(float)),
        "next_pymnt_d": _date_str(-rng.integers(5, 40, n).astype(float)),
        "last_credit_pull_d": _date_str(rng.integers(1, 400, n).astype(float)),
        "out_prncp": (loan_amnt * (1 - paid_frac)).round(2),
        "out_prncp_inv": (loan_amnt * (1 - paid_frac) * 0.99).round(2),
        # Extra numerics from the log-transform list (feature_engineering.py:118-130)
        "acc_now_delinq": rng.poisson(0.02, n).astype(float),
        "delinq_2yrs": rng.poisson(0.3, n).astype(float),
        "inq_last_6mths": rng.poisson(0.6, n).astype(float),
        # Dense low-information columns present in the raw table
        # (01_data_cleaning.ipynb cell 26: 0 nulls).
        "policy_code": np.ones(n),
        "delinq_amnt": np.where(rng.random(n) < 0.01,
                                _lognormal(rng, 7, 1, n), 0.0).round(0),
        "collections_12_mths_ex_med": rng.poisson(0.02, n).astype(float),
        "tax_liens": rng.poisson(0.05, n).astype(float),
        # hardship_status: mostly missing → filled "No Hardship" (clean_data.py:116-118)
        "hardship_status": _where_none(
            rng.random(n) < 0.95, "hardship_status",
            rng.choice(["ACTIVE", "BROKEN", "COMPLETE", "COMPLETED"], n)),
    }

    # --- Bureau-history block (shared ~2.4% missingness) ---------------------
    # In the real table (01_data_cleaning.ipynb cell 26) a ~2.4% row subset
    # misses the whole credit-bureau block at once; those rows then miss >20
    # columns and are dropped by the row-null allowance
    # (feature_engineering.py:66) — 99,995 -> 97,557 rows. Reproducing the
    # BLOCK structure (one shared mask, nested sub-blocks) reproduces that
    # row-drop behavior; independent per-column masks would not.
    m_core = rng.random(n) < 0.0244
    m_sats = m_core & (rng.random(n) < 0.84)  # num_bc_sats/num_sats subset
    m_1778 = m_sats & (rng.random(n) < 0.87)  # acc_open.../mort_acc subset

    def _blocked_col(vals: np.ndarray, mask: np.ndarray) -> np.ndarray:
        return np.where(mask, np.nan, vals)

    frame.update({
        "tot_coll_amt": _blocked_col(
            np.where(rng.random(n) < 0.12,
                     _lognormal(rng, 6, 1.3, n), 0.0).round(0), m_core),
        "tot_cur_bal": _blocked_col(
            np.clip(_lognormal(rng, 11.4, 1.0, n), 0, 3e6).round(0), m_core),
        "total_rev_hi_lim": _blocked_col(
            np.clip(_lognormal(rng, 10.1, 0.9, n), 0, 1e6).round(0), m_core),
        "mo_sin_old_rev_tl_op": _blocked_col(
            np.clip(rng.normal(180, 90, n), 2, 800).round(0), m_core),
        "mo_sin_rcnt_rev_tl_op": _blocked_col(
            rng.exponential(14, n).round(0), m_core),
        "mo_sin_rcnt_tl": _blocked_col(rng.exponential(8, n).round(0), m_core),
        "num_accts_ever_120_pd": _blocked_col(
            rng.poisson(0.5, n).astype(float), m_core),
        "num_actv_bc_tl": _blocked_col(rng.poisson(3.7, n).astype(float), m_core),
        "num_actv_rev_tl": _blocked_col(rng.poisson(5.6, n).astype(float), m_core),
        "num_bc_tl": _blocked_col(rng.poisson(7.7, n).astype(float), m_core),
        "num_il_tl": _blocked_col(rng.poisson(8.4, n).astype(float), m_core),
        "num_op_rev_tl": _blocked_col(rng.poisson(8.2, n).astype(float), m_core),
        "num_rev_accts": _blocked_col(num_rev_accts, m_core),
        "num_rev_tl_bal_gt_0": _blocked_col(
            rng.poisson(5.6, n).astype(float), m_core),
        "num_tl_30dpd": _blocked_col(rng.poisson(0.03, n).astype(float), m_core),
        "num_tl_90g_dpd_24m": _blocked_col(
            rng.poisson(0.08, n).astype(float), m_core),
        "num_tl_op_past_12m": _blocked_col(
            rng.poisson(2.1, n).astype(float), m_core),
        "tot_hi_cred_lim": _blocked_col(
            np.clip(_lognormal(rng, 11.8, 0.9, n), 0, 4e6).round(0), m_core),
        "total_il_high_credit_limit": _blocked_col(
            np.clip(_lognormal(rng, 10.4, 1.0, n), 0, 1.5e6).round(0), m_core),
        "num_bc_sats": _blocked_col(rng.poisson(4.7, n).astype(float), m_sats),
        "num_sats": _blocked_col(rng.poisson(11.6, n).astype(float), m_sats),
        "acc_open_past_24mths": _blocked_col(
            rng.poisson(4, n).astype(float), m_1778),
        "total_bal_ex_mort": _blocked_col(
            np.clip(_lognormal(rng, 10.6, 0.9, n), 0, 1.5e6).round(0), m_1778),
        "total_bc_limit": _blocked_col(
            np.clip(_lognormal(rng, 9.7, 1.0, n), 0, 6e5).round(0), m_1778),
        # Core-block members with small extra independent missingness, so the
        # NN path still sees surviving NaNs (-> _NA indicators, cell 18) after
        # the core rows are dropped.
        "avg_cur_bal": _blocked_col(
            np.clip(_lognormal(rng, 9.1, 1.0, n), 0, 5e5).round(0),
            m_core | (rng.random(n) < 0.005)),
        "bc_open_to_buy": _blocked_col(
            np.clip(_lognormal(rng, 8.8, 1.3, n), 0, 4e5).round(0),
            m_core | (rng.random(n) < 0.005)),
        "pct_tl_nvr_dlq": _blocked_col(
            np.clip(rng.normal(94, 8, n), 20, 100).round(1),
            m_core | (rng.random(n) < 0.005)),
        "percent_bc_gt_75": _blocked_col(
            np.clip(rng.normal(40, 34, n), 0, 100).round(1),
            m_core | (rng.random(n) < 0.005)),
        "bc_util": _blocked_col(
            np.clip(rng.normal(57, 28, n), 0, 200).round(1),
            m_core | (rng.random(n) < 0.005)),
        "mo_sin_old_il_acct": _blocked_col(
            np.clip(rng.normal(130, 60, n), 1, 600).round(0),
            m_core | (rng.random(n) < 0.03)),
        "num_tl_120dpd_2m": _blocked_col(
            rng.poisson(0.01, n).astype(float),
            m_core | (rng.random(n) < 0.03)),
    })

    # --- Installment/revolving detail block (shared ~29.6% missingness) ------
    # Pre-2015 originations lack these fields entirely, so they go missing
    # TOGETHER (cell 26: 29,644 nulls across the whole block). Survivors of
    # the row-null allowance keep these NaNs -> imputed + _NA indicators on
    # the NN path (03_feature_engineering.ipynb cell 18).
    m_il = rng.random(n) < 0.296
    frame.update({
        "open_act_il": _blocked_col(rng.poisson(2.4, n).astype(float), m_il),
        "open_il_12m": _blocked_col(open_il_12m, m_il),
        "open_il_24m": _blocked_col(open_il_24m.astype(float), m_il),
        "mths_since_rcnt_il": _blocked_col(
            rng.exponential(16, n).round(0), m_il),
        "total_bal_il": _blocked_col(
            np.clip(_lognormal(rng, 10.0, 1.1, n), 0, 1e6).round(0), m_il),
        "open_rv_12m": _blocked_col(rng.poisson(1.3, n).astype(float), m_il),
        "open_rv_24m": _blocked_col(rng.poisson(2.5, n).astype(float), m_il),
        "max_bal_bc": _blocked_col(max_bal_bc, m_il),
        "inq_fi": _blocked_col(rng.poisson(1.1, n).astype(float), m_il),
        "total_cu_tl": _blocked_col(rng.poisson(1.5, n).astype(float), m_il),
        # FILL_ZERO_COLS ride the same block (clean_data.py:140 fills them).
        "inq_last_12m": _blocked_col(rng.poisson(2, n).astype(float), m_il),
        "open_acc_6m": _blocked_col(rng.poisson(1, n).astype(float), m_il),
        "chargeoff_within_12_mths": np.where(rng.random(n) < 0.05, np.nan, 0.0),
        # il_util/all_util: the block plus extra (cell 26: 39.7% / 29.7%) —
        # both dropped as "unnecessary" during cleaning either way.
        "il_util": _blocked_col(
            rng.normal(0.7, 0.2, n).round(3), m_il | (rng.random(n) < 0.14)),
        "all_util": _blocked_col(rng.normal(0.6, 0.2, n).round(3), m_il),
    })

    # --- Moderately sparse month-since columns (independent missingness) -----
    frame.update({
        "mths_since_last_delinq": np.where(rng.random(n) < 0.5, np.nan,
                                           rng.exponential(34, n).round(0)),
        "mths_since_recent_bc": np.where(rng.random(n) < 0.1, np.nan,
                                         rng.exponential(25, n).round(0)),
        "mths_since_recent_inq": np.where(rng.random(n) < 0.13, np.nan,
                                          rng.exponential(7, n).round(0)),
        "mths_since_recent_revol_delinq": np.where(
            rng.random(n) < 0.67, np.nan, rng.exponential(35, n).round(0)),
        "mths_since_recent_bc_dlq": np.where(
            rng.random(n) < 0.77, np.nan, rng.exponential(39, n).round(0)),
    })

    # --- >70%-null blocks the cleaner must drop (clean_data.py:31-41) --------
    # Joint-application, secondary-applicant and hardship-detail blocks, plus
    # two very sparse month-since columns — all present in the raw table and
    # all above the 70% null threshold (cell 26 / cell 28).
    frame.update({
        "mths_since_last_record": np.where(
            rng.random(n) < 0.854, np.nan, rng.exponential(75, n).round(0)),
        "mths_since_last_major_derog": np.where(
            rng.random(n) < 0.754, np.nan, rng.exponential(44, n).round(0)),
    })
    m_joint = rng.random(n) < 0.928
    frame.update({
        "annual_inc_joint": _blocked_col(
            np.clip(_lognormal(rng, 11.6, 0.5, n), 1e4, 3e6).round(0), m_joint),
        "dti_joint": _blocked_col(
            np.clip(rng.normal(19, 7, n), 0, 60).round(2), m_joint),
        "verification_status_joint": _where_none(
            m_joint, "verification_status_joint", rng.choice(schema.VERIFICATION_STATUS, n)),
        "revol_bal_joint": _blocked_col(
            np.clip(_lognormal(rng, 9.8, 1.0, n), 0, 6e5).round(0),
            m_joint | (rng.random(n) < 0.06)),
    })
    m_sec = rng.random(n) < 0.9326
    frame.update({
        "sec_app_fico_range_low": _blocked_col(
            np.clip(rng.normal(690, 35, n), 630, 845).round(0), m_sec),
        "sec_app_fico_range_high": _blocked_col(
            np.clip(rng.normal(694, 35, n), 634, 849).round(0), m_sec),
        "sec_app_earliest_cr_line": _where_none(
            m_sec, "sec_app_earliest_cr_line",
            _date_str(np.clip(rng.normal(5400, 2400, n), 400, 20000))),
        "sec_app_inq_last_6mths": _blocked_col(
            rng.poisson(0.7, n).astype(float), m_sec),
        "sec_app_mort_acc": _blocked_col(
            rng.poisson(1.2, n).astype(float), m_sec),
        "sec_app_open_acc": _blocked_col(
            rng.poisson(11, n).astype(float), m_sec),
        "sec_app_revol_util": _blocked_col(
            np.clip(rng.normal(0.5, 0.25, n), 0, 1.5).round(3),
            m_sec | (rng.random(n) < 0.02)),
        "sec_app_open_act_il": _blocked_col(
            rng.poisson(2.5, n).astype(float), m_sec),
        "sec_app_num_rev_accts": _blocked_col(
            rng.poisson(13, n).astype(float), m_sec),
        "sec_app_chargeoff_within_12_mths": _blocked_col(
            rng.poisson(0.03, n).astype(float), m_sec),
        "sec_app_collections_12_mths_ex_med": _blocked_col(
            rng.poisson(0.04, n).astype(float), m_sec),
    })
    m_hard = rng.random(n) < 0.951
    # The hardship amount columns are present slightly more often than the
    # rest of the block (93.78% vs 95.1% null, cell 26).
    m_hard_amt = m_hard & (rng.random(n) < 0.986)
    frame.update({
        "hardship_type": _where_none(
            m_hard, "hardship_type", np.full(n, "INTEREST ONLY-3 MONTHS DEFERRAL")),
        "hardship_reason": _where_none(
            m_hard, "hardship_reason", rng.choice(["NATURAL_DISASTER", "DISABILITY",
                                                   "UNEMPLOYMENT", "INCOME_CURTAILMENT"], n)),
        "deferral_term": _blocked_col(np.full(n, 3.0), m_hard),
        "hardship_amount": _blocked_col(
            (installment * rng.uniform(0.1, 0.9, n)).round(2), m_hard_amt),
        "hardship_start_date": _where_none(
            m_hard, "hardship_start_date", _date_str(rng.integers(100, 1200, n).astype(float))),
        "hardship_end_date": _where_none(
            m_hard, "hardship_end_date", _date_str(rng.integers(10, 1100, n).astype(float))),
        "payment_plan_start_date": _where_none(
            m_hard, "payment_plan_start_date",
            _date_str(rng.integers(10, 1200, n).astype(float))),
        "hardship_length": _blocked_col(np.full(n, 3.0), m_hard),
        "hardship_dpd": _blocked_col(rng.poisson(12, n).astype(float), m_hard),
        "hardship_loan_status": _where_none(
            m_hard | (rng.random(n) < 0.003), "hardship_loan_status",
            rng.choice(["Late (16-30 days)", "Late (31-120 days)", "Current"], n)),
        "orig_projected_additional_accrued_interest": _blocked_col(
            (installment * rng.uniform(0.05, 0.5, n)).round(2),
            m_hard_amt | (rng.random(n) < 0.002)),
        "hardship_payoff_balance_amount": _blocked_col(
            (loan_amnt * rng.uniform(0.2, 1.0, n)).round(2), m_hard_amt),
        "hardship_last_payment_amount": _blocked_col(
            (installment * rng.uniform(0.1, 1.2, n)).round(2), m_hard_amt),
    })

    # >70%-null junk columns that the cleaner must drop (clean_data.py:31-41).
    for j in range(missing_junk_cols):
        col = rng.normal(0, 1, n)
        mask = rng.random(n) < 0.9
        frame[f"junk_sparse_{j}"] = np.where(mask, np.nan, col)

    # A handful of exact duplicate rows (clean_data.py:146-150).
    n_dup = max(1, int(n * duplicate_fraction))
    df = RawFrame(frame, missing)
    return df.concat(df.take(np.arange(n_dup)))
