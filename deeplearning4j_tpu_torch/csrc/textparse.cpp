// Native bulk CSV -> float32 parser for the data-loading path.
//
// Reference: datavec-api's CSVRecordReader parses record-at-a-time on
// the JVM (opencsv + Jackson); the hot path for numeric training CSVs
// is a single buffer sweep. This parser does one pass over the raw
// bytes into a row-major float32 matrix; anything it cannot prove is a
// clean numeric rectangle (ragged rows, non-numeric or empty fields)
// is rejected with a negative code and the caller falls back to the
// Python record loop, so semantics never silently change.
//
// Build: g++ -O2 -shared -fPIC (see runtime/textparse.py, same
// build-on-first-use scheme as runtime/ringbuffer.py).

#include <cstddef>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse delimited numeric text into float32 row-major.
//  - rows split on '\n'; trailing '\r'/spaces stripped; blank rows skipped
//  - the first `skip_rows` non-blank rows are dropped (headers)
//  - each field must parse COMPLETELY as a float (strtof), spaces trimmed
// Returns the row count and writes the column count to *ncols_out.
// Errors: -1 ragged row, -2 non-numeric/empty/oversized field,
//         -3 output capacity exceeded.
long tp_parse_f32(const char* buf, size_t len, char delim, long skip_rows,
                  float* out, long cap, long* ncols_out) {
    long rows = 0, ncols = -1, written = 0, skipped = 0;
    size_t i = 0;
    while (i < len) {
        size_t eol = i;
        while (eol < len && buf[eol] != '\n') eol++;
        size_t end = eol;
        while (end > i && (buf[end - 1] == '\r' || buf[end - 1] == ' ' ||
                           buf[end - 1] == '\t'))
            end--;
        size_t start = i;
        while (start < end && (buf[start] == ' ' || buf[start] == '\t'))
            start++;
        i = eol + 1;
        if (start == end) continue;  // blank line
        if (skipped < skip_rows) {
            skipped++;
            continue;
        }
        long c = 0;
        size_t p = start;
        while (true) {
            size_t q = p;
            while (q < end && buf[q] != delim) q++;
            size_t fp = p, flen = q - p;
            while (flen > 0 && (buf[fp] == ' ' || buf[fp] == '\t')) {
                fp++;
                flen--;
            }
            while (flen > 0 && (buf[fp + flen - 1] == ' ' ||
                                buf[fp + flen - 1] == '\t'))
                flen--;
            char tmp[64];
            if (flen == 0 || flen >= sizeof(tmp)) return -2;
            // strtof accepts a WIDER grammar than the Python path
            // (hex floats "0x1A", inf/nan, locale decimal commas) —
            // restrict to the plain decimal-float character set so the
            // fast path never parses what the record loop would reject
            for (size_t t = 0; t < flen; t++) {
                char ch = buf[fp + t];
                if (!((ch >= '0' && ch <= '9') || ch == '+' || ch == '-' ||
                      ch == '.' || ch == 'e' || ch == 'E'))
                    return -2;
            }
            memcpy(tmp, buf + fp, flen);
            tmp[flen] = 0;
            char* endp = nullptr;
            float v = strtof(tmp, &endp);
            if (endp != tmp + flen) return -2;
            if (written >= cap) return -3;
            out[written++] = v;
            c++;
            if (q >= end) break;
            p = q + 1;
        }
        if (ncols < 0) {
            ncols = c;
        } else if (c != ncols) {
            return -1;
        }
        rows++;
    }
    if (ncols_out) *ncols_out = ncols < 0 ? 0 : ncols;
    return rows;
}

}  // extern "C"
