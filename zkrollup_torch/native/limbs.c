/* The witness encoding of groth16/prove.py in one pass: a list of Python
 * ints to the canonical 16-bit limb rows of the BN254 scalar field, int32
 * (n, 16), little-endian limbs, as fields/limbs.py lays them out.
 *
 * An entry is taken here when it is an int (not a subclass) in [0, r); its
 * row is then ints_to_limbs([x % r])'s. Every other entry (another type, a
 * negative value, a value of r or more) is left to the caller, which
 * reduces it in Python; its row is not written. The caller holds the
 * interpreter lock for the call (ctypes.PyDLL), as the C API needs.
 *
 * Built by native/limbs.py into build/native/ at the repository root. */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

/* r as four little-endian 64-bit words */
static const uint64_t R[4] = {
    0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
    0xb85045b68181585dULL, 0x30644e72e131a029ULL};

/* x's value as four little-endian 64-bit words; -1 (no exception left set)
 * if x is negative or 2^256 or more */
static int as_words(PyObject *x, uint64_t w[4])
{
#if PY_VERSION_HEX >= 0x030C0000
    /* 3.12 and later: read the digits (PyLong_SHIFT bits each) and the
     * sign from the object, without the byte-at-a-time copy of the
     * public API */
    uintptr_t tag = ((PyLongObject *)x)->long_value.lv_tag;
    Py_ssize_t nd = (Py_ssize_t)(tag >> _PyLong_NON_SIZE_BITS);
    const digit *d = ((PyLongObject *)x)->long_value.ob_digit;
    unsigned __int128 acc = 0;
    int bits = 0, j = 0;
    if ((tag & _PyLong_SIGN_MASK) == 2)
        return -1;
    w[0] = w[1] = w[2] = w[3] = 0;
    for (Py_ssize_t i = 0; i < nd; i++) {
        acc |= (unsigned __int128)d[i] << bits;
        bits += PyLong_SHIFT;
        if (bits >= 64) {
            if (j == 4)
                return -1;
            w[j++] = (uint64_t)acc;
            acc >>= 64;
            bits -= 64;
        }
    }
    if (acc) {
        if (j == 4)
            return -1;
        w[j] = (uint64_t)acc;
    }
    return 0;
#else
    /* before 3.12: 32 little-endian bytes, unsigned (a negative value or
     * one of 2^256 or more sets an exception) */
    unsigned char b[32];
    if (_PyLong_AsByteArray((PyLongObject *)x, b, 32, 1, 0) < 0) {
        PyErr_Clear();
        return -1;
    }
    for (int j = 0; j < 4; j++) {
        w[j] = 0;
        for (int k = 7; k >= 0; k--)
            w[j] = (w[j] << 8) | b[8 * j + k];
    }
    return 0;
#endif
}

static int below_r(const uint64_t *w)
{
    for (int j = 3; j >= 0; j--)
        if (w[j] != R[j])
            return w[j] < R[j];
    return 0;
}

/* Rows of the entries of xs (a list of n entries) taken here into out
 * (n x 16 int32); the indices of the others into slow, in order. Returns
 * their count, or -1 if xs is not a list of n entries. */
Py_ssize_t zkl_fr_rows(PyObject *xs, Py_ssize_t n, int32_t *out,
                       int64_t *slow)
{
    if (!PyList_Check(xs) || PyList_GET_SIZE(xs) != n)
        return -1;
    Py_ssize_t k = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *x = PyList_GET_ITEM(xs, i);
        uint64_t w[4];
        if (!PyLong_CheckExact(x) || as_words(x, w) < 0 || !below_r(w)) {
            slow[k++] = i;
            continue;
        }
        int32_t *row = out + 16 * i;
        for (int j = 0; j < 16; j++)
            row[j] = (int32_t)((w[j >> 2] >> (16 * (j & 3))) & 0xFFFF);
    }
    return k;
}
