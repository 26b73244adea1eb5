// Row layout of the tracking state and the chain's per-epoch outputs,
// shared by the chunk correlator (chunk_corr.cuh) and the chain
// (track_chain.cu); mirrored by ops/track_chain.py (F_* / I_* / O_*).
//
// State: fst [n_frows(K), C] float32 and ist [N_IROWS, C] int32, one
// column per channel.  Per-epoch outputs: out_f [E, N_OROWS, C].

#pragma once

enum {
    F_REM_CODE = 0, F_DELTA, F_DOPPLER, F_REM_CARR, F_CARR_W, F_CARR_X,
    F_PREV_R, F_PREV_I, F_SABSI, F_SI2, F_SQ2, F_CN0, F_ACCH_R, F_ACCH_I,
    F_CARR_OFF, F_DLL_IN0 = 15, F_DLL_OUT0 = 18, F_ACC_R0 = 21
};
enum {
    I_ACTIVE = 0, I_START, I_CURLEN, I_PUSH, I_LOCKFAIL, I_EPOCHS, I_FLL_ON,
    I_MODE, I_EXTCNT, I_SEC_ON, I_SEC_IDX, I_LIMIT, N_IROWS
};
enum {
    O_DOPPLER = 0, O_DELTA, O_REM_CODE, O_REM_CARR, O_CN0, O_VALID,
    O_ACTIVE, N_OROWS
};
